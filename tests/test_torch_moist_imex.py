"""The port's moist IMEX step against the JAX package, in float64 on the
CPU, on the moist baroclinic wave at n_horz=2, n_vert=4, p3 (96
elements; 4 vertical elements, so the period-3 comb probes two elements
at once) on the JAX grid's arrays:

- the assembled vertical acoustic-gravity operator over the six
  variables: blocks of Nq3 · nvars = 4 · 6 = 24 unknowns (30 at p4),
  ``b_cols`` zero, the same active unknowns (ρq_tot has no linear flux,
  so at the interior nodes of a column its rows and columns are empty and
  compressed out; on the vertical faces the Rusanov flux's jump term
  couples it), the compressed L/D/U within 1e-12 of their largest
  entry;
- ``solve_blocks`` and ``apply_op_blocks`` at α = 0.3, 2.0, 25.0
  against JAX's, 1e-10 relative, as tests/test_torch_imex.py holds the
  dry ones;
- one and three ARK2GKC steps of each package's
  ``IMEXSolverType().make`` (the frozen-operator probe runs the
  saturation adjustment) from the initial state perturbed by 1e-3 with
  ρq_tot raised to supersaturation on a third of the nodes (numpy, seed
  19), at dt = 0.01 · the horizontal node distance / 350 m/s (28 s):
  per variable 5e-12 of its largest magnitude, the dry steps' tolerance
  (the column solve mixes ρe round-off into the momentum), and the aux
  the step carries out (the moist RHS writes it on every call) to the
  same 5e-12: aux is a function of the state, and its q_ice lane, an
  excess q_tot − q_sat, shows the state's differences at 4.2e-12 of its
  largest value after three steps.
  The baroclinic wave has no filter, and at this coarse grid the split
  is unstable at the dry Held-Suarez tests' 0.1 (281 s; NaN at the
  second step in both packages) and at 0.02 (the fourth): the explicit
  remainder carries the vertical acoustics of the state's departure
  from the reference temperature, on ~2 km vertical node spacing.

The JAX solver is built once for the module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init_ode_state
from climatemachine_tpu.driver.solver_types import \
    IMEXSolverType as JaxIMEXSolverType
from climatemachine_tpu.experiments.baroclinic_wave import \
    baroclinic_wave_config as jax_baroclinic_wave_config
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu_torch.dg.spatial import DGModel
from climatemachine_tpu_torch.driver.solver_types import IMEXSolverType
from climatemachine_tpu_torch.experiments.baroclinic_wave import \
    baroclinic_wave_config
from climatemachine_tpu_torch.interop import (grid_from_numpy,
                                              grid_to_numpy,
                                              state_from_numpy)

SIZE = dict(n_horz=2, n_vert=4, poly_order=3)
ALPHAS = [0.3, 2.0, 25.0]


def _rel_err_per_var(got_vm, ref_vm):
    got, ref = np.asarray(got_vm), np.asarray(ref_vm)
    scale = np.maximum(np.max(np.abs(ref), axis=(0, 2)), 1e-300)
    return np.max(np.abs(got - ref), axis=(0, 2)) / scale


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)


@pytest.fixture(scope="module")
def setup():
    """Both packages' moist IMEX solvers from the initial state, the test
    state and the JAX states and aux after one and three steps."""
    cfg_j = jax_baroclinic_wave_config(dtype=np.float64, **SIZE)
    dg_j = JaxDGModel(cfg_j.model, cfg_j.grid)
    q0, aux0 = jax_init_ode_state(dg_j)
    rng = np.random.default_rng(19)
    q = np.asarray(q0) * (1 + 1e-3 * rng.standard_normal(q0.shape))
    wet = rng.uniform(size=q[..., 5].shape) < 1 / 3
    q[..., 5] = np.where(wet, 4.0 * q[..., 5] + 2e-3 * q[..., 0], q[..., 5])
    dt = 0.01 * jax_min_node_distance(cfg_j.grid, "horizontal") / 350.0

    imex_j = JaxIMEXSolverType().make(dg_j, q0, aux0, dt)
    vm = imex_j.vm
    assert vm is not None and vm.moist
    qv, auxv = vm.to_vm(jnp.asarray(q)), vm.aux_to_vm(aux0)
    steps_j = {}
    for i in range(3):
        qv, auxv = imex_j.step(qv, auxv, i * dt)
        steps_j[i + 1] = (np.asarray(qv), np.asarray(auxv))

    cfg_t = baroclinic_wave_config(dtype=torch.float64, device="cpu", **SIZE)
    grid_t = grid_from_numpy(grid_to_numpy(cfg_j.grid), device="cpu",
                             dtype=torch.float64)
    dg_t = DGModel(cfg_t.model, grid_t)
    q0_t, aux0_t = state_from_numpy(q0, aux0, device="cpu")
    imex_t = IMEXSolverType().make(dg_t, q0_t, aux0_t, dt)
    return dict(q=q, aux0=aux0, dt=dt, imex_j=imex_j, steps_j=steps_j,
                imex_t=imex_t)


def test_moist_operator_blocks_match_jax(setup):
    sj, st = setup["imex_j"].solver, setup["imex_t"].solver
    assert st.layout.nvars == 6 and st.nb == 4 * 6
    assert float(jnp.max(jnp.abs(sj.b_cols))) == 0.0
    assert float(st.b_cols.abs().max()) == 0.0
    np.testing.assert_array_equal(st._sel.numpy(), np.asarray(sj._sel))
    assert st.active_count == len(sj._sel) < st.nb
    # ρq_tot (variable 5 of each of the Nq3 = 4 nodes of the block) is
    # compressed out at the interior nodes k = 1, 2, kept on the faces
    sel = set(st._sel.tolist())
    assert not sel & {1 * 6 + 5, 2 * 6 + 5} and {5, 3 * 6 + 5} <= sel
    for got, ref in ((st.Lc, sj.Lc), (st.Dc, sj.Dc), (st.Uc, sj.Uc)):
        got = got.permute(0, 3, 2, 1)      # [nv, ncol, i, j] → JAX's layout
        assert tuple(got.shape) == ref.shape
        assert _rel_err(got.numpy(), ref) < 1e-12


@pytest.mark.parametrize("alpha", ALPHAS)
def test_moist_solve_and_apply_match_jax(setup, alpha):
    sj, st = setup["imex_j"].solver, setup["imex_t"].solver
    rhs = np.random.default_rng(int(alpha * 10)).standard_normal(
        tuple(st.b_cols.shape))
    got = st.solve_blocks(torch.tensor(rhs), alpha)
    assert _rel_err(got.numpy(), sj.solve_blocks(jnp.asarray(rhs),
                                                 alpha)) < 1e-10
    applied = st.apply_op_blocks(torch.tensor(rhs))
    assert _rel_err(applied.numpy(),
                    sj.apply_op_blocks(jnp.asarray(rhs))) < 1e-10


@pytest.mark.parametrize("nsteps", [1, 3])
def test_moist_imex_steps_match_jax(setup, nsteps):
    imex, dt = setup["imex_t"], setup["dt"]
    assert imex.vm.write_aux and imex.rhs_full is imex.vm
    qv, auxv = state_from_numpy(setup["q"], setup["aux0"], device="cpu")
    for i in range(nsteps):
        qv, auxv = imex.step(qv, auxv, i * dt)
    q_ref, aux_ref = setup["steps_j"][nsteps]
    err = _rel_err_per_var(qv, q_ref)
    assert err.max() < 5e-12, err
    assert _rel_err_per_var(auxv, aux_ref).max() < 5e-12
