"""The port's moist var-major RHS and explicit step against the JAX
package, in float64 on the CPU, on the moist baroclinic wave (EquilMoist,
EquilMoistBiharmonic(8 h), Gravity, Coriolis) at n_horz=2, n_vert=2, p3
on the JAX grid's arrays:

- the RHS under each surface pass ("xla", "hybrid", "pallas") against
  JAX ``VarMajorRHS(dg, chain_kernel="pallas")`` with the "pallas"
  surface pass (every moist Pallas kernel, in interpret mode), on the
  initial state perturbed by 1e-3 with ρq_tot raised to supersaturation
  on a third of the nodes (numpy, seed 17): per variable 1e-11 of its
  largest magnitude, the tests/test_fast_rhs.py precedent; the aux it
  returns (the saturation adjustment's T, θ_v, q_liq, q_ice) 1e-11;
- one LSRK54 step through ``ExplicitSolverType().make`` of each package
  from that state, state and aux 1e-12 (the moist RHS writes its aux
  lanes on every call, so the aux after a step is the last stage's);
- the refusals around the moist model: the var-major surface pass
  called directly on it, and a dry hyperdiffusion on a moist model (the
  generic DG operator and its solver routes take it);
- the port's float32 against float64 on the CPU for the small moist
  references of chip_smoke.py (tests/moist_precision_gap.py, which also
  measures the JAX package's): within a fifth of the card's tolerance,
  which is 10× the larger of the two packages' gaps.
"""

import jax.numpy as jnp
import moist_precision_gap
import numpy as np
import pytest
import torch

import chip_smoke

from climatemachine_tpu.dg.fast_rhs import VarMajorRHS as JaxVarMajorRHS
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init_ode_state
from climatemachine_tpu.driver.solver_types import \
    ExplicitSolverType as JaxExplicitSolverType
from climatemachine_tpu.experiments.baroclinic_wave import \
    baroclinic_wave_config as jax_baroclinic_wave_config
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu_torch.atmos.hyperdiffusion import DryBiharmonic
from climatemachine_tpu_torch.atmos.model import AtmosModel
from climatemachine_tpu_torch.dg import fast_surface
from climatemachine_tpu_torch.dg.fast_rhs import SURFACE_KERNELS, VarMajorRHS
from climatemachine_tpu_torch.dg.spatial import DGModel
from climatemachine_tpu_torch.driver.solver_types import (ExplicitSolverType,
                                                          IMEXSolverType)
from climatemachine_tpu_torch.experiments.baroclinic_wave import \
    baroclinic_wave_config
from climatemachine_tpu_torch.interop import (grid_from_numpy,
                                              grid_to_numpy,
                                              state_from_numpy)

SIZE = dict(n_horz=2, n_vert=2, poly_order=3)


def moist_test_state(q0, seed):
    """The initial state times 1 + 1e-3·N(0, 1), with ρq_tot raised to
    4 ρq_tot + 2e-3 ρ (supersaturated) on a third of the nodes."""
    rng = np.random.default_rng(seed)
    q = np.asarray(q0) * (1 + 1e-3 * rng.standard_normal(np.shape(q0)))
    wet = rng.uniform(size=q[..., 5].shape) < 1 / 3
    q[..., 5] = np.where(wet, 4.0 * q[..., 5] + 2e-3 * q[..., 0], q[..., 5])
    return q


def _rel_err_per_var(got_vm, ref_vm):
    got, ref = np.asarray(got_vm), np.asarray(ref_vm)
    scale = np.maximum(np.max(np.abs(ref), axis=(0, 2)), 1e-300)
    return np.max(np.abs(got - ref), axis=(0, 2)) / scale


@pytest.fixture(scope="module")
def setup():
    """Both packages' moist configurations (the port's on the JAX grid's
    arrays), the JAX initial state and the test state, and the JAX RHS
    on it with every moist Pallas kernel (interpret mode)."""
    cfg_j = jax_baroclinic_wave_config(dtype=np.float64, **SIZE)
    dg_j = JaxDGModel(cfg_j.model, cfg_j.grid)
    q0, aux0 = jax_init_ode_state(dg_j)
    q = moist_test_state(q0, 17)
    vm_j = JaxVarMajorRHS(dg_j, chain_kernel="pallas")
    vm_j.surface_kernel = "pallas"
    dq_ref, aux_ref = vm_j(vm_j.to_vm(jnp.asarray(q)), vm_j.aux_to_vm(aux0),
                           0.0)
    cfg_t = baroclinic_wave_config(dtype=torch.float64, device="cpu", **SIZE)
    grid_t = grid_from_numpy(grid_to_numpy(cfg_j.grid), device="cpu",
                             dtype=torch.float64)
    return dict(cfg_j=cfg_j, dg_j=dg_j, q0=q0, aux0=aux0, q=q,
                dq_ref=np.asarray(dq_ref), aux_ref=np.asarray(aux_ref),
                cfg_t=cfg_t, dg_t=DGModel(cfg_t.model, grid_t))


def test_test_state_condenses(setup):
    sp = setup["cfg_t"].model.aux_spec
    aux = setup["aux_ref"]
    assert (aux[:, sp.index("moisture.q_liq").start] > 0).sum() > 100
    assert (aux[:, sp.index("moisture.q_ice").start] > 0).sum() > 100


@pytest.mark.parametrize("mode", SURFACE_KERNELS)
def test_moist_rhs_matches_jax(setup, mode):
    qv, auxv = state_from_numpy(setup["q"], setup["aux0"], device="cpu",
                                model=setup["cfg_t"].model)
    rhs = VarMajorRHS(setup["dg_t"], write_aux=False)
    rhs.surface_kernel = mode
    dq, aux = rhs(qv, auxv, 0.0)
    err = _rel_err_per_var(dq, setup["dq_ref"])
    assert dq.shape[1] == 6 and err.max() < 1e-11, err
    # the moisture lanes are written whatever write_aux says
    assert _rel_err_per_var(aux, setup["aux_ref"]).max() < 1e-11


def test_static_moist_coefficients(setup):
    """ν₄ and ν₄_q, built once from the grid, equal (Δ/2)⁴/2τ and
    (Δ/2)⁴/2τ_q on the aux lane hyperdiffusion.delta (τ_q = τ by
    default)."""
    rhs = VarMajorRHS(setup["dg_t"])
    hd = setup["cfg_t"].model.physics.hyperdiffusion
    assert hd.tau_timescale_q_tot == hd.tau_timescale
    _, aux = state_from_numpy(setup["q"], setup["aux0"], device="cpu")
    delta = setup["cfg_t"].model.aux_spec.get(aux, "hyperdiffusion.delta")
    for lane, tau in ((0, hd.tau_timescale), (1, hd.tau_timescale_q_tot)):
        ref = (delta / 2) ** 4 / (2 * tau)
        assert (rhs.nu[:, lane] - ref).abs().max() <= 1e-14 * ref.max()


def test_explicit_solver_type_step_matches_jax(setup):
    """One LSRK54 step through each package's ``ExplicitSolverType().make``
    from the test state: state and the aux it carries out of the step."""
    cfg_j, dg_j, dg_t = setup["cfg_j"], setup["dg_j"], setup["dg_t"]
    dt = 0.25 * jax_min_node_distance(cfg_j.grid) / 360.0
    ex_j = JaxExplicitSolverType().make(dg_j, setup["q0"], setup["aux0"], dt)
    assert ex_j.vm is not None and ex_j.vm.moist
    q_ref, aux_ref = ex_j.step(ex_j.vm.to_vm(jnp.asarray(setup["q"])),
                               ex_j.vm.aux_to_vm(setup["aux0"]), 0.0)

    qv, auxv = state_from_numpy(setup["q"], setup["aux0"], device="cpu")
    ex = ExplicitSolverType().make(dg_t, qv, auxv, dt)
    assert ex.vm.write_aux and ex.rhs is ex.vm
    q1, aux1 = ex.step(qv, auxv, 0.0)
    err = _rel_err_per_var(q1, q_ref)
    assert err.max() < 1e-12, err
    assert _rel_err_per_var(aux1, aux_ref).max() < 1e-12
    # and aux is the last stage's thermo, not the initial one
    assert not torch.equal(aux1, auxv)


def test_moist_refusals(setup):
    """The generic DG operator and its solver routes take the moist model
    now (tests/test_torch_tracers.py holds them against the JAX
    package's): what is left refused is the var-major surface pass
    called directly on it (its surface term is the node-gather pass's)
    and a dry hyperdiffusion on a moist model."""
    dg_t, model = setup["dg_t"], setup["cfg_t"].model
    qv, auxv = state_from_numpy(setup["q"], setup["aux0"], device="cpu")
    assert not dg_t.fast_surface
    dq, _ = dg_t(qv, auxv, 0.0)
    assert dq.shape == qv.shape and bool(torch.isfinite(dq).all())
    with pytest.raises(ValueError, match="node-gather"):
        fast_surface.surface_tendency(dg_t, qv, auxv, 0.0)
    assert ExplicitSolverType(state_layout="grid").make(
        dg_t, qv, auxv, 1.0).rhs is dg_t
    for kw in (dict(state_layout="grid"), dict(columnwise_solver="dense")):
        assert IMEXSolverType(**kw).make(dg_t, qv, auxv, 1.0).vm is None
    from dataclasses import replace
    dry_hd = AtmosModel(replace(model.physics,
                                hyperdiffusion=DryBiharmonic(3600.0)),
                        model.problem, model.sources)
    with pytest.raises(ValueError, match="EquilMoistBiharmonic"):
        VarMajorRHS(DGModel(dry_hd, dg_t.grid))


@pytest.mark.parametrize("solver", list(moist_precision_gap.CASES))
def test_float32_gap_within_chip_tolerance(solver):
    tol = (chip_smoke.MOIST_IMEX_SMALL_TOL if solver == "IMEX"
           else chip_smoke.MOIST_SMALL_TOL)
    gap = moist_precision_gap.port_gap(solver)
    assert len(gap) == len(tol) == 6
    assert all(g <= t / 5 for g, t in zip(gap, tol)), (gap, tol)
