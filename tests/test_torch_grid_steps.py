"""The port's steps on the generic DG operator (``state_layout="grid"``)
against the JAX package's, in float64 on the CPU at n_horz=2, n_vert=3,
p3 on the JAX grid's arrays, with DryBiharmonic(8 h) and the every-step
filter, from a seeded perturbation of the JAX initial state:

- one LSRK54 step of ``ExplicitSolverType(state_layout="grid").make``
  (the generic DG operator as the RHS, its ``pre_stage`` before each
  stage): 1e-12 of max|q| per variable;
- the port's LSRK54 ``pre_stage`` hook runs before each of the five
  stages, with the stage time;
- one ARK2GKC step of ``IMEXSolverType(state_layout="grid").make`` (the
  banded column solver's block loop, the generic DG operator as
  ``rhs_full``): 5e-12 of max|q| per variable, the precedent of
  tests/test_torch_imex.py (the column solve mixes ρe's round-off, ~3e4,
  into ρu; measured 5e-13, on ρe).

The JAX steps use the JAX package's defaults on the CPU: the XLA volume
contraction and the generic surface pass (tests/test_torch_generic_dg.py
holds the RHS against both of the JAX package's volume paths).  The
JAX set-up check of the frozen operator is skipped (it changes nothing
the step computes and costs ~10 s of eager compilation); the port's
runs.  The dense IMEX path is in tests/test_torch_dense_imex.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init_ode_state
from climatemachine_tpu.driver.solver_types import \
    ExplicitSolverType as JaxExplicitSolverType
from climatemachine_tpu.driver.solver_types import \
    IMEXSolverType as JaxIMEXSolverType
from climatemachine_tpu.experiments.held_suarez import \
    HeldSuarezStepFilter as JaxHeldSuarezStepFilter
from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu_torch.dg.spatial import DGModel
from climatemachine_tpu_torch.driver.solver_types import (ExplicitSolverType,
                                                          IMEXSolverType)
from climatemachine_tpu_torch.experiments.held_suarez import (
    HeldSuarezStepFilter, held_suarez_config)
from climatemachine_tpu_torch.interop import (grid_from_numpy,
                                              grid_to_numpy,
                                              state_from_numpy, to_var_major)

SIZE = dict(n_horz=2, n_vert=3, poly_order=3)


@pytest.fixture(scope="module")
def setup():
    """JAX config and its perturbed initial state; the port's model and
    filter on the JAX grid's arrays."""
    cfg_j = jax_held_suarez_config(dtype=np.float64, **SIZE)
    dg_j = JaxDGModel(cfg_j.model, cfg_j.grid)
    q0, aux0 = jax_init_ode_state(dg_j)
    rng = np.random.default_rng(23)
    q = np.asarray(q0) * (1 + 1e-3 * rng.standard_normal(q0.shape))
    cfg_t = held_suarez_config(dtype=torch.float64, device="cpu", **SIZE)
    grid_t = grid_from_numpy(grid_to_numpy(cfg_j.grid), device="cpu",
                             dtype=torch.float64)
    return dict(cfg_j=cfg_j, dg_j=dg_j, q0=q0, aux0=aux0, q=q,
                filt_j=JaxHeldSuarezStepFilter(cfg_j.grid,
                                               cfg_j.model).apply,
                dg_t=DGModel(cfg_t.model, grid_t),
                filt_t=HeldSuarezStepFilter(grid_t, cfg_t.model).apply_vm)


def _err_of_max(got_vm, ref_node_major):
    """max |got − ref| per variable, relative to max |ref| over all
    variables (the state's largest magnitude, ρe's)."""
    ref = to_var_major(ref_node_major, "cpu").numpy()
    return np.max(np.abs(got_vm.numpy() - ref), axis=(0, 2)) / np.abs(
        ref).max()


def _step_both(setup, jax_solver, port_solver):
    jax_solver.post_step = setup["filt_j"]
    port_solver.post_step = setup["filt_t"]
    # jitted (the ARK step jits itself): one compilation, faster than
    # eager dispatch
    q_ref, _ = jax.jit(lambda q, a: jax_solver.step(q, a, 0.0))(
        jnp.asarray(setup["q"]), setup["aux0"])
    qt, auxt = state_from_numpy(setup["q"], setup["aux0"], device="cpu")
    q1, _ = port_solver.step(qt, auxt, 0.0)
    return _err_of_max(q1, q_ref)


def test_explicit_grid_step_matches_jax(setup):
    dt = 0.3 * jax_min_node_distance(setup["cfg_j"].grid) / 350.0
    make = lambda st, dg: st(state_layout="grid").make(
        dg, setup["q0"] if dg is setup["dg_j"] else None, None, dt)
    ex_j = make(JaxExplicitSolverType, setup["dg_j"])
    ex_t = make(ExplicitSolverType, setup["dg_t"])
    assert ex_j.vm is None and ex_t.vm is None
    assert ex_t.rhs is setup["dg_t"]
    err = _step_both(setup, ex_j, ex_t)
    assert err.max() < 1e-12, err


def test_explicit_grid_pre_stage_runs_each_stage(setup):
    """The generic operator's ``pre_stage`` (the identity for the
    AtmosModel) is called before every stage at the stage's time."""
    dg = setup["dg_t"]
    seen = []

    class Recording(DGModel):
        def pre_stage(self, q, aux, t):
            seen.append(t)
            return super().pre_stage(q, aux, t)

    rec = Recording(dg.balance_law, dg.grid)
    ex = ExplicitSolverType(state_layout="grid").make(rec, None, None, 2.0)
    qt, auxt = state_from_numpy(setup["q"], setup["aux0"], device="cpu")
    ex.step(qt, auxt, 10.0)
    assert seen == [10.0 + 2.0 * c for c in ex.C]


def test_imex_grid_step_matches_jax(setup):
    dt = 0.1 * jax_min_node_distance(setup["cfg_j"].grid,
                                     "horizontal") / 350.0
    im_j = JaxIMEXSolverType(state_layout="grid",
                             check_frozen_operator=False).make(
        setup["dg_j"], setup["q0"], setup["aux0"], dt)
    qt0, auxt0 = state_from_numpy(setup["q0"], setup["aux0"], device="cpu")
    im_t = IMEXSolverType(state_layout="grid").make(setup["dg_t"], qt0,
                                                    auxt0, dt)
    assert im_j.vm is None and im_t.vm is None
    assert im_t.rhs_full is setup["dg_t"]
    err = _step_both(setup, im_j, im_t)
    assert err.max() < 5e-12, err
