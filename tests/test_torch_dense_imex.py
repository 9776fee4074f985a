"""The port's dense IMEX step against the JAX package's, in float64 on
the CPU at n_horz=2, n_vert=3, p3 on the JAX grid's arrays, with
DryBiharmonic(8 h) and the every-step filter, from a seeded perturbation
of the JAX initial state, dt from the horizontal acoustic CFL:

- one and three steps of ``IMEXSolverType(columnwise_solver="dense")
  .make`` (the dense ``ManyColumnSolver``, the grid-layout loop
  ``_step_impl`` on the fused remainder): 5e-12 of max|q| per variable,
  the precedent of tests/test_torch_imex.py (the column solve mixes ρe's
  round-off, ~3e4, into ρu; measured 3e-12, on ρe);
- the dense solver's assembled operator A against JAX's (1e-12 of its
  largest entry), and its ``solve`` (with the kept factors) and
  ``apply_op`` (with ``op_args``) against the port's banded solver at
  α = 0.3, 2.0, 25.0, 1e-9 and 1e-11 relative (tests/test_imex.py:54-81);
- the dense step's implicit tendency by ``implied_g`` "dg" and
  "identity" against "op" (the port takes all three; the JAX package
  keeps "identity" to float64).

The JAX set-up check of the frozen operator is skipped (it changes
nothing a step computes and costs ~10 s of eager compilation); the
port's runs.  The grid-layout banded IMEX step is in
tests/test_torch_grid_steps.py.
"""

import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init_ode_state
from climatemachine_tpu.driver.solver_types import \
    IMEXSolverType as JaxIMEXSolverType
from climatemachine_tpu.experiments.held_suarez import \
    HeldSuarezStepFilter as JaxHeldSuarezStepFilter
from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu_torch.dg.spatial import DGModel
from climatemachine_tpu_torch.driver.solver_types import IMEXSolverType
from climatemachine_tpu_torch.experiments.held_suarez import (
    HeldSuarezStepFilter, held_suarez_config)
from climatemachine_tpu_torch.interop import (grid_from_numpy,
                                              grid_to_numpy,
                                              state_from_numpy, to_var_major)
from climatemachine_tpu_torch.solvers.columnwise import ManyColumnSolver

SIZE = dict(n_horz=2, n_vert=3, poly_order=3)
ALPHAS = [0.3, 2.0, 25.0]
STEP_TOL = 5e-12


def _steps(solver, q, aux, dt, n):
    out = []
    for i in range(n):
        q, aux = solver.step(q, aux, i * dt)
        out.append(q)
    return out


@pytest.fixture(scope="module")
def setup():
    """Both packages' dense IMEX solvers with the filter and their states
    after one and three steps from the perturbed state; the port's
    banded solver."""
    cfg_j = jax_held_suarez_config(dtype=np.float64, **SIZE)
    dg_j = JaxDGModel(cfg_j.model, cfg_j.grid)
    q0, aux0 = jax_init_ode_state(dg_j)
    rng = np.random.default_rng(29)
    q = np.asarray(q0) * (1 + 1e-3 * rng.standard_normal(q0.shape))
    dt = 0.1 * jax_min_node_distance(cfg_j.grid, "horizontal") / 350.0
    filt_j = JaxHeldSuarezStepFilter(cfg_j.grid, cfg_j.model).apply

    cfg_t = held_suarez_config(dtype=torch.float64, device="cpu", **SIZE)
    grid_t = grid_from_numpy(grid_to_numpy(cfg_j.grid), device="cpu",
                             dtype=torch.float64)
    dg_t = DGModel(cfg_t.model, grid_t)
    filt_t = HeldSuarezStepFilter(grid_t, cfg_t.model).apply_vm
    q0_t, aux0_t = state_from_numpy(q0, aux0, device="cpu")
    qt, auxt = state_from_numpy(q, aux0, device="cpu")


    im_j = JaxIMEXSolverType(columnwise_solver="dense",
                             check_frozen_operator=False).make(
        dg_j, q0, aux0, dt)
    im_j.post_step = filt_j
    im_t = IMEXSolverType(columnwise_solver="dense").make(dg_t, q0_t, aux0_t,
                                                          dt)
    im_t.post_step = filt_t
    return dict(
        dt=dt, qt=qt, auxt=auxt, jax=im_j, port=im_t,
        banded=IMEXSolverType().make(dg_t, q0_t, aux0_t, dt).solver,
        ref=[to_var_major(s, "cpu") for s in _steps(im_j, q, aux0, dt, 3)],
        got=_steps(im_t, qt, auxt, dt, 3))


def _err_of_max(got, ref):
    """max |got − ref| per variable, relative to max |ref| over all
    variables (the state's largest magnitude, ρe's)."""
    return ((got - ref).abs().amax(dim=(0, 2)) / ref.abs().max()).numpy()


@pytest.mark.parametrize("steps", [1, 3])
def test_imex_dense_steps_match_jax(setup, steps):
    port = setup["port"]
    assert isinstance(port.solver, ManyColumnSolver)
    assert not hasattr(port.solver, "solve_blocks")     # the _step_impl loop
    assert port.rhs_full is None and port.rhs_ex.remainder is not None
    assert port.vm is None and setup["jax"].vm is None
    err = _err_of_max(setup["got"][steps - 1], setup["ref"][steps - 1])
    assert err.max() < STEP_TOL, err


def test_dense_operator_matches_jax(setup):
    A_j = np.asarray(setup["jax"].solver.A)
    A_t = setup["port"].solver.A.numpy()
    assert A_t.shape == A_j.shape
    assert np.max(np.abs(A_t - A_j)) < 1e-12 * np.max(np.abs(A_j))


@pytest.mark.parametrize("alpha", ALPHAS)
def test_dense_solve_and_apply_match_banded(setup, alpha):
    dense, banded = setup["port"].solver, setup["banded"]
    x = setup["qt"]
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    want = banded.solve(x, alpha)
    assert rel(dense.solve(x, alpha), want) < 1e-9
    assert rel(dense.solve(x, alpha, factors=dense.prefactorize(alpha)),
               want) < 1e-9
    assert rel(dense.apply_op(x, dense.op_args()), banded.apply_op(x)) < 1e-11
    with pytest.raises(NotImplementedError, match="next slice"):
        dense.op_args(torch.bfloat16)


@pytest.mark.parametrize("mode", ["dg", "identity"])
def test_dense_implied_g_modes_match_op(setup, mode):
    """The implicit tendency from the vertical DG operator ("dg") or from
    the solve itself ("identity") instead of the assembled operator: the
    same step to round-off in float64."""
    port = setup["port"]
    port.solver.implied_g = mode
    try:
        q1, _ = port.step(setup["qt"], setup["auxt"], 0.0)
    finally:
        del port.solver.implied_g
    err = _err_of_max(q1, setup["got"][0])
    assert err.max() < STEP_TOL, err
