"""The generic DG operator's gradient (second-order) path in the port
against the JAX package's, in float64 on the CPU (tests/les_parity.py:
the rising bubble on the 3 × 3 × 3 LES box at p3, lateral sides
periodic, walls at the bottom (tag 1) and top (tag 2)), from the
initial state times 1 + 1e-3·N(0, 1) (numpy seed 0):

- ``spatial_gradient`` (strong gradient plus the lifted central jump,
  wall ghosts from ``boundary_state``) within 1e-12 of its largest
  magnitude;
- the RHS with SmagorinskyLilly (free-slip insulating walls), Vreman
  (no-slip walls), AnisoMinDiss (DragLaw and BulkFormulaEnergy at the
  bottom), ConstantKinematicViscosity (a DragLaw of a callable
  coefficient and a PrescribedTemperature at the bottom, a
  PrescribedEnergyFlux at the top); with EquilMoist (3 Newton steps of
  the saturation adjustment) and a bulk moisture flux; with NTracers;
  with SmagorinskyLilly and DryBiharmonic together (the hyper state on
  the face bundle, masked on walls): each within 1e-11 per
  variable of the JAX RHS's largest magnitude of that variable (the
  momentum's components over the largest);
- the refusals: the var-major RHS takes no closure, so "auto" puts the
  model on the generic operator and "vm" raises; the generic operator
  takes neither the dry volume kernel nor the var-major surface pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from climatemachine_tpu import driver_api as jcm
from climatemachine_tpu_torch import driver_api as cm
from climatemachine_tpu_torch.dg import fast_rhs
from climatemachine_tpu_torch.dg.fast_rhs import VarMajorRHS
from les_parity import (grids, jax_model, nm, perturbed, port_model,
                        rel_err_per_var, vm)

TOL = 1e-11
GRAD_TOL = 1e-12


def _drag(model, q, aux, t, speed):
    """A callable drag coefficient of the wall speed."""
    return 1e-3 + 1e-4 * speed


#: closures, walls (bottom, top) and the moist and tracer hooks; the
#: default wall is the impenetrable free-slip, insulating, impermeable one
CASES = {
    "smagorinsky": lambda m: dict(turbulence=m.SmagorinskyLilly(0.21)),
    "vreman_noslip": lambda m: dict(
        turbulence=m.Vreman(0.21),
        bcs=(m.AtmosBC(momentum=m.NoSlip()), m.AtmosBC())),
    "anisomindiss_drag_bulk_energy": lambda m: dict(
        turbulence=m.AnisoMinDiss(),
        bcs=(m.AtmosBC(momentum=m.Impenetrable(m.DragLaw(0.0044)),
                       energy=m.BulkFormulaEnergy(C_h=1e-3, T_sfc=305.0)),
             m.AtmosBC())),
    "ckv_drag_callable_temperature": lambda m: dict(
        turbulence=m.ConstantKinematicViscosity(50.0),
        bcs=(m.AtmosBC(momentum=m.Impenetrable(m.DragLaw(_drag)),
                       energy=m.PrescribedTemperature(302.0)),
             m.AtmosBC(energy=m.PrescribedEnergyFlux(-50.0)))),
    "moist": lambda m: dict(
        turbulence=m.SmagorinskyLilly(0.21), moisture=m.EquilMoist(3),
        bcs=(m.AtmosBC(momentum=m.Impenetrable(m.DragLaw(0.0044)),
                       moisture=m.BulkFormulaMoisture(1e-3, 0.012)),
             m.AtmosBC())),
    "tracers": lambda m: dict(turbulence=m.ConstantKinematicViscosity(50.0),
                              tracers=m.NTracers((1.0, 2.0))),
    "smagorinsky_hyper": lambda m: dict(
        turbulence=m.SmagorinskyLilly(0.21),
        hyperdiffusion=m.DryBiharmonic(3600.0)),
}


@pytest.fixture(scope="module")
def box():
    return grids(3, 3)


def _setup(box, case):
    """Both DG operators of ``case`` and the perturbed state with its aux,
    node-major JAX arrays (the port's initial state, which
    test_torch_les_driver.py holds against the JAX package's: an eager
    JAX initialization costs seconds a case)."""
    gj, gp = box
    mj, mp = jax_model(**CASES[case](jcm)), port_model(**CASES[case](cm))
    dgj, dgp = jcm.DGModel(mj, gj), cm.DGModel(mp, gp)
    q0, aux0 = cm.init_ode_state(dgp)
    return dgj, dgp, jnp.asarray(perturbed(nm(q0))), jnp.asarray(nm(aux0))


def test_spatial_gradient(box):
    dgj, dgp, q, aux0 = _setup(box, "smagorinsky")
    aux = dgp.balance_law.update_auxiliary_state(vm(q), vm(aux0), dgp.grid)
    ref = np.asarray(jax.jit(dgj.spatial_gradient)(
        q, jnp.asarray(nm(aux)), 0.0))                    # [E, Np, 3, ng]
    got = dgp.spatial_gradient(vm(q), aux, 0.0)           # [E, 3, ng, Np]
    assert got.shape == (ref.shape[0], 3, ref.shape[3], ref.shape[1])
    got = np.moveaxis(got.numpy(), -1, 1)
    assert np.max(np.abs(got - ref)) <= GRAD_TOL * np.max(np.abs(ref))
    # the face term is in: the strong gradient alone is off by far more
    from climatemachine_tpu_torch.dg.spatial import strong_gradient
    g = dgp.balance_law.compute_gradient_argument(vm(q), aux, 0.0)
    strong = np.moveaxis(strong_gradient(dgp.grid, g, (0, 1, 2)).numpy(),
                         -1, 1)
    assert np.max(np.abs(strong - ref)) > 1e3 * GRAD_TOL * np.max(
        np.abs(ref))


@pytest.mark.parametrize("case", list(CASES))
def test_rhs_matches_jax(box, case):
    dgj, dgp, q, aux0 = _setup(box, case)
    ref, aux_ref = jax.jit(dgj.__call__)(q, aux0, 0.0)
    got, aux_got = dgp(vm(q), vm(aux0), 0.0)
    assert not dgp.dry_volume and not dgp.fast_surface
    err = rel_err_per_var(nm(got), ref)
    assert np.all(err <= TOL), err
    aux_err = np.max(np.abs(nm(aux_got) - np.asarray(aux_ref)), axis=(0, 1))
    assert np.all(aux_err <= 1e-12 * np.maximum(
        np.max(np.abs(np.asarray(aux_ref)), axis=(0, 1)), 1.0))


def test_closure_takes_the_generic_operator(box):
    """A closure: fast_rhs.supports false, VarMajorRHS and "vm" refuse,
    "auto" builds the generic operator's LSRK54 (solver.vm None); the
    DGModel takes neither the dry volume kernel (not even with
    volume_kernel="pallas", as the JAX package's does not with a gradient
    flux) nor the var-major surface pass.  Without the closure the same
    model takes both and "auto" the var-major RHS."""
    _, gp = box
    mp = port_model(turbulence=cm.SmagorinskyLilly(0.21))
    dg = cm.DGModel(mp, gp)
    q, aux = cm.init_ode_state(dg)
    assert dg.n_gradient == 5 and not fast_rhs.supports(dg)
    assert not dg.dry_volume and not dg.fast_surface
    assert not cm.DGModel(mp, gp, volume_kernel="pallas").dry_volume
    with pytest.raises(ValueError, match="turbulence closure"):
        VarMajorRHS(dg)
    with pytest.raises(ValueError, match="state_layout='vm'"):
        cm.ExplicitSolverType(state_layout="vm").make(dg, q, aux, 0.1)
    assert cm.ExplicitSolverType().make(dg, q, aux, 0.1).vm is None
    inviscid = cm.DGModel(port_model(), gp)
    assert inviscid.n_gradient == 0
    assert inviscid.dry_volume and inviscid.fast_surface
    assert fast_rhs.supports(inviscid)
    assert cm.ExplicitSolverType().make(inviscid, q, aux, 0.1).vm is not None
