"""The solver types that reach the fused remainder through the generic
DG operator, against the JAX package's, in float64 on the CPU on dry
Held-Suarez with DryBiharmonic(8 h) on the JAX grid's arrays, from a
seeded perturbation (numpy) of the JAX initial state:

- ``MultirateRungeKutta`` on dq/dt = λ_s q + λ_f q (the problem of
  tests/test_solvers_fluxes.py:46-62): second-order coupling and 1e-4 at
  20 steps, as the JAX test asks, and the JAX integrator's result on
  the same problem within 1e-14;
- ``MultirateSolverType(timestep_ratio=4).make`` at n_horz=2, n_vert=3,
  p3, slow dt = 4 · 0.3 · min_node_distance / 350 (tests/test_imex.py:
  206-229), two steps: per variable 1e-12 of max|q| (measured under
  1e-17 after one step: 40 RHS a step, each at round-off of the JAX
  one); the fast model is the acoustic-gravity
  model in every direction, the slow operator the fused remainder in
  every direction (``lin_dims`` (0, 1, 2) of the dry volume kernel);
- ``IMEXSolverType(implicit_model=AtmosAcousticLinearModel,
  columnwise_solver="dense").make`` at n_horz=2, n_vert=3, p3 with the
  every-step filter (the dense solver's grid-layout loop on the acoustic
  remainder, ``lin_dims`` (2,) without gravity): one and two steps
  within 5e-12 of max|q| per variable, the precedent of
  tests/test_torch_dense_imex.py.  dt = 0.005 · horizontal node
  distance / 350 m/s (8.7 s): at 0.1 and 0.02 (the dense IMEX tests'
  0.1 with the acoustic-gravity model) the acoustic split turns to NaN
  within the first step in both packages, and at 0.01 the port's
  second step does.

The JAX solvers run their right-hand sides jitted (the multirate step's
slow and fast operators, the IMEX step's explicit and implicit ones) and
their stage algebra eagerly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.atmos.linear import \
    AtmosAcousticLinearModel as JaxAtmosAcousticLinearModel
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init_ode_state
from climatemachine_tpu.driver.solver_types import \
    IMEXSolverType as JaxIMEXSolverType
from climatemachine_tpu.driver.solver_types import \
    MultirateSolverType as JaxMultirateSolverType
from climatemachine_tpu.experiments.held_suarez import \
    HeldSuarezStepFilter as JaxHeldSuarezStepFilter
from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu.ode.lsrk import \
    LSRK54CarpenterKennedy as JaxLSRK54CarpenterKennedy
from climatemachine_tpu.ode.multirate import \
    MultirateRungeKutta as JaxMultirateRungeKutta
from climatemachine_tpu_torch.atmos.linear import (
    AtmosAcousticGravityLinearModel, AtmosAcousticLinearModel)
from climatemachine_tpu_torch.dg.spatial import DGModel
from climatemachine_tpu_torch.driver.solver_types import (
    IMEXSolverType, MultirateSolverType)
from climatemachine_tpu_torch.experiments.held_suarez import (
    HeldSuarezStepFilter, held_suarez_config)
from climatemachine_tpu_torch.interop import (grid_from_numpy,
                                              grid_to_numpy,
                                              state_from_numpy, to_var_major)
from climatemachine_tpu_torch.ode.lsrk import LSRK54CarpenterKennedy
from climatemachine_tpu_torch.ode.multirate import MultirateRungeKutta
from climatemachine_tpu_torch.solvers.columnwise import ManyColumnSolver

SIZE = dict(n_horz=2, n_vert=3, poly_order=3)
MULTIRATE_TOL = 1e-12
IMEX_TOL = 5e-12
#: the acoustic dense IMEX step's dt over the horizontal node distance
#: / 350 m/s (module docstring)
ACOUSTIC_CFL = 0.005


def _err_of_max(got, ref):
    """max |got − ref| per variable over max |ref| of all variables."""
    return ((got - ref).abs().amax(dim=(0, 2)) / ref.abs().max()).numpy()


# --- the multirate integrator on a scalar problem --------------------------------

LAM_S, LAM_F = -0.3, -3.0


def _scalar_multirate(n, slow_ctor, fast_ctor, multirate, array):
    dt = 1.0 / n
    slow = slow_ctor(lambda q, a, t: (LAM_S * q, a), dt)
    fast = fast_ctor(lambda q, a, t: (LAM_F * q, a), dt / 8)
    mr = multirate(slow, fast, dt=dt)
    q, aux, t = array([1.0]), None, 0.0
    for _ in range(n):
        q, aux = mr.step(q, aux, t)
        t += dt
    return float(q[0])


def test_multirate_converges_and_matches_jax():
    exact = np.exp(LAM_S + LAM_F)
    port = {n: _scalar_multirate(
        n, LSRK54CarpenterKennedy, LSRK54CarpenterKennedy,
        MultirateRungeKutta, lambda x: torch.tensor(x, dtype=torch.float64))
        for n in (20, 40)}
    e20, e40 = abs(port[20] - exact), abs(port[40] - exact)
    assert e20 < 1e-4
    assert np.log2(e20 / e40) > 1.5          # at least 2nd-order coupling
    jax_q = _scalar_multirate(20, JaxLSRK54CarpenterKennedy,
                              JaxLSRK54CarpenterKennedy,
                              JaxMultirateRungeKutta, jnp.asarray)
    assert abs(port[20] - jax_q) < 1e-14


# --- the solver types on Held-Suarez ----------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_held_suarez_config(dtype=np.float64, **SIZE)
    dg_j = JaxDGModel(cfg_j.model, cfg_j.grid)
    q0, aux0 = jax_init_ode_state(dg_j)
    rng = np.random.default_rng(37)
    q = np.asarray(q0) * (1 + 1e-3 * rng.standard_normal(q0.shape))
    cfg_t = held_suarez_config(dtype=torch.float64, device="cpu", **SIZE)
    grid_t = grid_from_numpy(grid_to_numpy(cfg_j.grid), device="cpu",
                             dtype=torch.float64)
    q0_t, aux0_t = state_from_numpy(q0, aux0, device="cpu")
    qt, auxt = state_from_numpy(q, aux0, device="cpu")
    return dict(cfg_j=cfg_j, dg_j=dg_j, q0=q0, aux0=aux0, q=q, cfg_t=cfg_t,
                dg_t=DGModel(cfg_t.model, grid_t), q0_t=q0_t, aux0_t=aux0_t,
                qt=qt, auxt=auxt)


def _steps(solver, q, aux, n, to_port=lambda q: q):
    out = []
    for i in range(n):
        q, aux = solver.step(q, aux, i * solver.dt)
        out.append(to_port(q))
    return out


def test_multirate_solver_type_matches_jax(setup):
    dt = 4 * 0.3 * jax_min_node_distance(setup["cfg_j"].grid) / 350.0
    st_j = JaxMultirateSolverType(timestep_ratio=4)
    mr_j = st_j.make(setup["dg_j"], setup["q0"], setup["aux0"], dt)
    mr_j.slow.rhs, mr_j.fast.rhs = (jax.jit(mr_j.slow.rhs),
                                    jax.jit(mr_j.fast.rhs))
    ref = _steps(mr_j, jnp.asarray(setup["q"]), setup["aux0"], 2,
                 lambda q: to_var_major(q, "cpu"))

    st = MultirateSolverType(timestep_ratio=4)
    assert type(st.getdtmodel(setup["cfg_t"].model)) is \
        AtmosAcousticGravityLinearModel
    mr = st.make(setup["dg_t"], setup["q0_t"], setup["aux0_t"], dt)
    assert mr.vm is None and mr.dt == dt and mr.fast.dt == dt / 4
    assert mr.dt_fixed and mr.slow.dt_fixed
    assert mr.slow.rhs.remainder[1] == "every"
    assert mr.fast.rhs.direction == "every" and mr.slow.nstages == 5
    got = _steps(mr, setup["qt"], setup["auxt"], 2)
    for g, r in zip(got, ref):
        err = _err_of_max(g, r)
        assert err.max() < MULTIRATE_TOL, err
    assert bool(torch.isfinite(got[-1]).all())
    assert (got[-1][:, 1:4] / got[-1][:, :1]).abs().max() < 100.0


def test_dense_acoustic_imex_matches_jax(setup):
    dt = ACOUSTIC_CFL * jax_min_node_distance(setup["cfg_j"].grid,
                                              "horizontal") / 350.0
    im_j = JaxIMEXSolverType(implicit_model=JaxAtmosAcousticLinearModel,
                             columnwise_solver="dense",
                             check_frozen_operator=False).make(
        setup["dg_j"], setup["q0"], setup["aux0"], dt)
    im_j.post_step = JaxHeldSuarezStepFilter(setup["cfg_j"].grid,
                                             setup["cfg_j"].model).apply
    im_j.rhs_ex, im_j.rhs_im = jax.jit(im_j.rhs_ex), jax.jit(im_j.rhs_im)
    ref = _steps(im_j, jnp.asarray(setup["q"]), setup["aux0"], 2,
                 lambda q: to_var_major(q, "cpu"))

    im = IMEXSolverType(implicit_model=AtmosAcousticLinearModel,
                        columnwise_solver="dense").make(
        setup["dg_t"], setup["q0_t"], setup["aux0_t"], dt)
    im.post_step = HeldSuarezStepFilter(setup["dg_t"].grid,
                                        setup["cfg_t"].model).apply_vm
    assert isinstance(im.solver, ManyColumnSolver)
    assert type(im.rhs_ex.remainder[0]) is AtmosAcousticLinearModel
    got = _steps(im, setup["qt"], setup["auxt"], 2)
    for g, r in zip(got, ref):
        err = _err_of_max(g, r)
        assert err.max() < IMEX_TOL, err
