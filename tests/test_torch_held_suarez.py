"""The port's dry Held-Suarez slice against the JAX package, in float64 on
the CPU at n_horz=2, n_vert=2, p3, each case twice: with hyperdiffusion
off and with the default DryBiharmonic(8 h) in both:

- the aux and prognostic lane names;
- the initial state and aux (``hyperdiffusion.delta`` included) against
  JAX ``init_ode_state``, 1e-12 relative;
- the var-major RHS on a perturbed state against JAX
  ``VarMajorRHS(dg, chain_kernel="pallas")`` (its Pallas volume and chain
  kernels run in interpret mode), 1e-11 relative per variable, the
  tests/test_fast_rhs.py precedent;
- one LSRK54 step with the every-step filter, 1e-12 relative (the JAX
  step runs its default chain, which tests/test_fast_rhs.py holds to
  the Pallas chain at round-off), built by hand and through the explicit
  entry point ``ExplicitSolverType().make`` of both packages.

The RHS and step tests feed both packages the JAX grid's arrays
(interop.grid_from_numpy) so they hold the RHS apart from the grid
build, which tests/test_torch_grid.py covers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.fast_rhs import VarMajorRHS as JaxVarMajorRHS
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init_ode_state
from climatemachine_tpu.driver.solver_types import \
    ExplicitSolverType as JaxExplicitSolverType
from climatemachine_tpu.experiments.held_suarez import \
    HeldSuarezStepFilter as JaxHeldSuarezStepFilter
from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu.ode.lsrk import \
    LSRK54CarpenterKennedy as JaxLSRK54CarpenterKennedy
from climatemachine_tpu_torch.dg.fast_rhs import VarMajorRHS
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.driver.solver_types import ExplicitSolverType
from climatemachine_tpu_torch.experiments.held_suarez import (
    HeldSuarezStepFilter, held_suarez_config)
from climatemachine_tpu_torch.interop import (grid_from_numpy,
                                              grid_to_numpy,
                                              state_from_numpy)
from climatemachine_tpu_torch.ode.lsrk import LSRK54CarpenterKennedy

SIZE = dict(n_horz=2, n_vert=2, poly_order=3)
TAUS = [None, 8 * 3600.0]


@pytest.fixture(scope="module", params=TAUS, ids=["hd_off", "hd_on"])
def setup(request):
    """JAX config, its initial state perturbed from a seeded numpy
    generator, and the port's model on the JAX grid's arrays, with the
    hyperdiffusion timescale of the parameter."""
    tau = request.param
    cfg_j = jax_held_suarez_config(dtype=np.float64, hyperdiffusion_tau=tau,
                                   **SIZE)
    dg_j = JaxDGModel(cfg_j.model, cfg_j.grid)
    q0, aux0 = jax_init_ode_state(dg_j)
    rng = np.random.default_rng(7)
    q = np.asarray(q0) * (1 + 1e-3 * rng.standard_normal(q0.shape))

    cfg_t = held_suarez_config(dtype=torch.float64, hyperdiffusion_tau=tau,
                               device="cpu", **SIZE)
    grid_t = grid_from_numpy(grid_to_numpy(cfg_j.grid), device="cpu",
                             dtype=torch.float64)
    return dict(tau=tau, cfg_j=cfg_j, dg_j=dg_j, q0=q0, aux0=aux0, q=q,
                cfg_t=cfg_t, dg_t=DGModel(cfg_t.model, grid_t))


def _rel_err_per_var(got_vm, ref_vm):
    """max |got − ref| over elements and nodes, per variable, relative to
    max |ref| of that variable; both var-major [E, n, Np]."""
    got, ref = np.asarray(got_vm), np.asarray(ref_vm)
    scale = np.maximum(np.max(np.abs(ref), axis=(0, 2)), 1e-300)
    return np.max(np.abs(got - ref), axis=(0, 2)) / scale


def test_aux_lanes_match_jax(setup):
    names = setup["cfg_t"].model.aux_spec.flattened_names()
    assert ("hyperdiffusion.delta" in names) == (setup["tau"] is not None)
    assert list(setup["cfg_t"].model.aux_spec.flattened_names()) == \
        list(setup["cfg_j"].model.aux_spec.flattened_names())
    assert list(setup["cfg_t"].model.prog_spec.flattened_names()) == \
        list(setup["cfg_j"].model.prog_spec.flattened_names())


def test_init_state_matches_jax(setup):
    cfg_t = setup["cfg_t"]
    q, aux = init_ode_state(DGModel(cfg_t.model, cfg_t.grid))
    q_ref, aux_ref = state_from_numpy(setup["q0"], setup["aux0"],
                                      device="cpu")
    assert q.dtype == aux.dtype == torch.float64
    assert _rel_err_per_var(q, q_ref).max() < 1e-12
    assert _rel_err_per_var(aux, aux_ref).max() < 1e-12


def test_rhs_matches_jax(setup):
    vm_j = JaxVarMajorRHS(setup["dg_j"], chain_kernel="pallas")
    dq_ref, aux_ref = vm_j(vm_j.to_vm(jnp.asarray(setup["q"])),
                           vm_j.aux_to_vm(setup["aux0"]), 0.0)
    qv, auxv = state_from_numpy(setup["q"], setup["aux0"], device="cpu")
    dq, aux = VarMajorRHS(setup["dg_t"])(qv, auxv, 0.0)
    err = _rel_err_per_var(dq, dq_ref)
    assert err.max() < 1e-11, err
    assert _rel_err_per_var(aux, aux_ref).max() < 1e-11


def test_static_hyper_coefficients_match_aux_lane(setup):
    """ν₄, built once from the grid, equals (Δ/2)⁴/2τ on the aux lane
    hyperdiffusion.delta that init_ode_state fills."""
    cfg_t = setup["cfg_t"]
    dg = DGModel(cfg_t.model, cfg_t.grid)
    rhs = VarMajorRHS(dg)
    if setup["tau"] is None:
        assert rhs.hd is None and not hasattr(rhs, "nu")
        return
    _, aux = init_ode_state(dg)
    delta = cfg_t.model.aux_spec.get(aux, "hyperdiffusion.delta")
    nu4 = (delta / 2) ** 4 / (2 * setup["tau"])
    torch.testing.assert_close(rhs.nu[:, 0], nu4.reshape(rhs.nu[:, 0].shape),
                               rtol=0, atol=0)
    assert not rhs.nu[:, 1].any()
    torch.testing.assert_close(rhs.nu4_faces, nu4 @ cfg_t.grid.lift, rtol=0,
                               atol=0)


def _jax_step(setup):
    """One JAX LSRK54 step with the filter from the perturbed state (dt,
    RHS, q1, aux1), computed once per fixture."""
    if "jax_step" not in setup:
        cfg_j, dg_j = setup["cfg_j"], setup["dg_j"]
        dt = 0.3 * jax_min_node_distance(cfg_j.grid) / 350.0
        vm_j = JaxVarMajorRHS(dg_j)
        sol_j = JaxLSRK54CarpenterKennedy(vm_j, dt)
        sol_j.post_step = JaxHeldSuarezStepFilter(cfg_j.grid,
                                                  cfg_j.model).apply_vm
        q_ref, aux_ref = sol_j.step(vm_j.to_vm(jnp.asarray(setup["q"])),
                                    vm_j.aux_to_vm(setup["aux0"]), 0.0)
        setup["jax_step"] = (dt, vm_j, q_ref, aux_ref)
    return setup["jax_step"]


@pytest.mark.parametrize("write_aux", [True, False],
                         ids=["write_aux", "deferred_aux"])
def test_lsrk54_step_with_filter_matches_jax(setup, write_aux):
    dt, vm_j, q_ref, aux_ref = _jax_step(setup)

    dg_t = setup["dg_t"]
    rhs = VarMajorRHS(dg_t, write_aux=write_aux)
    hsf = HeldSuarezStepFilter(dg_t.grid, dg_t.balance_law)
    sol = LSRK54CarpenterKennedy(rhs, dt, post_step=hsf.apply_vm)
    qv, auxv = state_from_numpy(setup["q"], setup["aux0"], device="cpu")
    q1, aux1 = sol.step(qv, auxv, 0.0)
    err = _rel_err_per_var(q1, q_ref)
    assert err.max() < 1e-12, err
    if not write_aux:
        aux1 = rhs.export_aux(q1, aux1)
        # JAX refreshed aux from the last stage's state, before the
        # filter: refresh it from the filtered state as well
        _, _, _, aux_ref = vm_j._thermo_update(q_ref, aux_ref, 0.0)
    assert _rel_err_per_var(aux1, aux_ref).max() < 1e-12


def test_explicit_solver_type_step_matches_jax(setup):
    """One step through the explicit entry point of each package,
    ``ExplicitSolverType().make`` with the filter as ``post_step`` set by
    the caller (bench.py:170-171), from the perturbed state."""
    cfg_j, dg_j, dg_t = setup["cfg_j"], setup["dg_j"], setup["dg_t"]
    dt = 0.3 * jax_min_node_distance(cfg_j.grid) / 350.0
    ex_j = JaxExplicitSolverType().make(dg_j, setup["q0"], setup["aux0"], dt)
    assert ex_j.vm is not None
    ex_j.post_step = JaxHeldSuarezStepFilter(cfg_j.grid, cfg_j.model).apply_vm
    q_ref, aux_ref = ex_j.step(ex_j.vm.to_vm(jnp.asarray(setup["q"])),
                               ex_j.vm.aux_to_vm(setup["aux0"]), 0.0)

    qv, auxv = state_from_numpy(setup["q"], setup["aux0"], device="cpu")
    ex = ExplicitSolverType().make(dg_t, qv, auxv, dt)
    ex.post_step = HeldSuarezStepFilter(dg_t.grid, dg_t.balance_law).apply_vm
    q1, aux1 = ex.step(qv, auxv, 0.0)
    err = _rel_err_per_var(q1, q_ref)
    assert err.max() < 1e-12, err
    assert _rel_err_per_var(ex.vm.export_aux(q1, aux1),
                            ex_j.vm.export_aux(q_ref, aux_ref)).max() < 1e-12
