"""The driver's checkpoints, restarts and step monitors in the port, in
float64 on the CPU (float32 for the round trip too), on Held-Suarez
through the driver entry (``experiments/held_suarez.py``
``held_suarez_driver``: n_horz 2, n_vert 2, p3), against the JAX
package where it has the same function:

- ``write_checkpoint``/``read_checkpoint``: the file's name and keys,
  the node-major layout, bit for bit in float32 and float64; a sharded
  file refused;
- a restart (``make_solver_configuration(restart_from=...)``) after k
  steps and a checkpoint at the end, then k more, equals 2k steps in one
  run bit for bit, explicit and IMEX (dt a dyadic number, so that
  every t and dt of both runs is exact);
- a checkpoint the JAX package writes restarts the port (its state
  exactly), and the JAX ``read_checkpoint`` reads the port's file;
- ``checkpoint_on_crash``: the state of the step that crashed, nothing
  with the setting off; keep-one rotation of the ``checkpoint`` interval;
- ``AdaptTimestep``'s new dt against the JAX callback's on the same
  state (explicit: 1e-12 relative); with the IMEX solver type, where the
  JAX callback raises (its linear dt model lacks the AtmosModel's state
  accessors), against the
  reference's c_ref Δt/Δx computed by the JAX package's functions; the
  IMEX step then factors at the new dt only;
- ``MonitorCourant``'s numbers against the JAX ``courant`` (1e-12
  relative), the timestep monitor's samples (per step, also on a
  simulated-time interval), ``show_not_finite_fields``.
"""

import logging
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg import courant as jcourant
from climatemachine_tpu.driver import callbacks as jcbs
from climatemachine_tpu.driver import checkpoint as jcp
from climatemachine_tpu.driver.solver_types import \
    IMEXSolverType as JaxIMEXSolverType
from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu.physics import thermodynamics as jtd
from climatemachine_tpu_torch import driver_api as cm
from climatemachine_tpu_torch.driver import callbacks as cbs
from climatemachine_tpu_torch.driver import checkpoint as cp
from climatemachine_tpu_torch.experiments.held_suarez import \
    held_suarez_driver
from climatemachine_tpu_torch.interop import state_to_numpy

SIZE = dict(n_horz=2, n_vert=2, poly_order=3)
#: a dyadic dt: k·dt, 2k·dt and their quotients are exact
DT = {"explicit": 0.5, "imex": 8.0}
K = 2
TOL = 1e-12


def hs(solver="explicit", timeend=0.0, restart_from=None, dt=None,
       dtype=torch.float64):
    """Held-Suarez through the driver entry on the CPU."""
    return held_suarez_driver(timeend=timeend, imex=solver == "imex",
                              dtype=dtype, device="cpu",
                              restart_from=restart_from,
                              ode_dt=DT[solver] if dt is None else dt,
                              **SIZE)


@pytest.fixture(autouse=True)
def settings(tmp_path):
    cm.init(show_updates="never", checkpoint_dir=str(tmp_path))
    yield tmp_path
    cm.init(show_updates="never")


@pytest.fixture(scope="module")
def jax_hs():
    """The JAX configuration of the same size (its grid's nodes are the
    port's)."""
    return jax_held_suarez_config(dtype=np.float64, **SIZE)


def node_major(sc):
    return tuple(jnp.asarray(a) for a in state_to_numpy(sc.q, sc.aux))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_checkpoint_round_trip(settings, dtype):
    sc = hs(dtype=dtype)
    path = cp.write_checkpoint(str(settings), "heldsuarez", 3, sc.q, sc.aux,
                               12.5, 7)
    assert os.path.basename(path) == \
        "heldsuarez_checkpoint_rank0000_num0003.npz"
    with np.load(path) as f:
        assert sorted(f.files) == ["aux", "q", "step", "t"]
        assert f["q"].shape == (sc.q.shape[0], sc.q.shape[2], sc.q.shape[1])
    q, aux, t, step = cp.read_checkpoint(str(settings), "heldsuarez", 3)
    assert (t, step) == (12.5, 7) and q.dtype == aux.dtype
    sc2 = hs(restart_from=(str(settings), 3), dtype=dtype)
    assert sc2.t0 == 12.5
    assert torch.equal(sc2.q, sc.q) and torch.equal(sc2.aux, sc.aux)
    assert sc2.q.dtype == dtype and sc2.q.is_contiguous()
    # the JAX package's sharded rank files are refused
    np.savez(cp.checkpoint_path(str(settings), "sharded", 0),
             q__nshards=np.int64(1), t=0.0, step=0)
    with pytest.raises(NotImplementedError, match="next slice"):
        cp.read_checkpoint(str(settings), "sharded", 0)


@pytest.mark.parametrize("solver", ["explicit", "imex"])
def test_restart_equals_unbroken_run(settings, solver):
    dt = DT[solver]
    whole = hs(solver, 2 * K * dt)
    cm.invoke(whole)
    cm.init(show_updates="never", checkpoint_dir=str(settings),
            checkpoint_at_end=True)
    first = hs(solver, K * dt)
    cm.invoke(first)
    cm.init(show_updates="never", checkpoint_dir=str(settings))
    second = held_suarez_driver(timeend=2 * K * dt, imex=solver == "imex",
                                dtype=torch.float64, device="cpu",
                                restart_from=(str(settings), 9999),
                                ode_dt=dt, **SIZE)
    assert second.t0 == K * dt and second.dt == dt
    cm.invoke(second)
    assert torch.equal(second.q, whole.q)
    assert not torch.equal(first.q, whole.q)


def test_jax_checkpoint_restarts_port(settings):
    """The JAX package writes the port's state; the port restarts from it
    exactly and steps as it would from its own; the JAX package reads the
    port's checkpoint exactly."""
    sc = hs(timeend=K * DT["explicit"])
    qj, auxj = node_major(sc)
    jcp.write_checkpoint(str(settings), "heldsuarez", 1, qj, auxj, 0.0, 0)
    sc_j = hs(timeend=K * DT["explicit"], restart_from=(str(settings), 1))
    assert torch.equal(sc_j.q, sc.q) and torch.equal(sc_j.aux, sc.aux)
    cm.invoke(sc)
    cm.invoke(sc_j)
    assert torch.equal(sc_j.q, sc.q)
    cp.write_checkpoint(str(settings), "heldsuarez", 2, sc.q, sc.aux, 1.0, K)
    q, aux, t, step = jcp.read_checkpoint(str(settings), "heldsuarez", 2)
    qn, auxn = state_to_numpy(sc.q, sc.aux)
    assert np.array_equal(q, qn) and np.array_equal(aux, auxn)
    assert (t, step) == (1.0, K)


class Bomb:
    def call(self, state):
        if state.step >= 3:
            raise RuntimeError("boom")
        return False


def test_checkpoint_on_crash(settings):
    cm.init(show_updates="never", checkpoint_dir=str(settings),
            checkpoint_on_crash=True)
    sc = hs(timeend=10 * DT["explicit"])
    with pytest.raises(RuntimeError, match="boom"):
        cm.invoke(sc, user_callbacks=(Bomb(),))
    q, aux, t, step = cp.read_checkpoint(str(settings), "heldsuarez", 9999)
    assert step == 3 and abs(t - 3 * DT["explicit"]) < 1e-12
    assert np.all(np.isfinite(q))
    # the state of step 3, which the crash left behind
    ref = hs(timeend=3 * DT["explicit"])
    cm.init(show_updates="never", checkpoint_dir=str(settings))
    cm.invoke(ref)
    assert np.array_equal(q, state_to_numpy(ref.q, ref.aux)[0])
    # with the setting off a crash writes nothing
    os.remove(cp.checkpoint_path(str(settings), "heldsuarez", 9999))
    with pytest.raises(RuntimeError, match="boom"):
        cm.invoke(hs(timeend=10 * DT["explicit"]), user_callbacks=(Bomb(),))
    assert not os.path.exists(
        cp.checkpoint_path(str(settings), "heldsuarez", 9999))


@pytest.mark.parametrize("keep_one", [True, False])
def test_checkpoint_rotation(settings, keep_one):
    cm.init(show_updates="never", checkpoint_dir=str(settings),
            checkpoint="2steps", checkpoint_keep_one=keep_one)
    sc = hs(timeend=6 * DT["explicit"])
    cm.invoke(sc)
    files = sorted(os.listdir(settings))
    nums = [0, 1, 2] if not keep_one else [2]
    assert files == [os.path.basename(cp.checkpoint_path(
        str(settings), "heldsuarez", n)) for n in nums]
    q, _, t, step = cp.read_checkpoint(str(settings), "heldsuarez", 2)
    assert step == 6 and np.array_equal(q, state_to_numpy(sc.q,
                                                          sc.aux)[0])


class State:
    def __init__(self, q, aux, step=1, t=0.0):
        self.q, self.aux, self.step, self.t = q, aux, step, t


def adapt(cb, q, aux):
    cb.init(State(q, aux, 0))
    cb.call(State(q, aux, 1))


def test_adapt_timestep_explicit_against_jax(jax_hs):
    """The explicit type's dt model is the balance law: the JAX
    callback's dt on the same (node-major) state."""
    sc = hs()
    sc.cfl = 0.3
    adapt(cbs.AdaptTimestep(sc, every_steps=1).make(), sc.q, sc.aux)

    class SC:
        pass

    scj = SC()
    scj.dg = type("DG", (), dict(grid=jax_hs.grid,
                                 balance_law=jax_hs.model))()
    scj.cfl, scj.cfl_direction, scj.ode_solver_type = 0.3, "every", None
    scj.solver = type("S", (), dict(dt=123.0))()
    adapt(jcbs.AdaptTimestep(scj, every_steps=1).make(), *node_major(sc))
    assert sc.solver.dt != DT["explicit"]
    assert abs(sc.solver.dt - scj.solver.dt) <= TOL * scj.solver.dt


def test_adapt_timestep_imex_against_jax(jax_hs, caplog):
    """The IMEX type's dt model is its linear model, whose non-diffusive
    Courant number is c_ref dt / Δx (the reference's; the JAX
    ``nondiffusive_courant`` reads the state through the AtmosModel's
    accessors, which the JAX linear model lacks, and the JAX callback
    raises AttributeError).  The next IMEX step
    factors at the new dt and keeps no other factorization."""
    sc = hs("imex", timeend=4 * DT["imex"])
    sc.cfl, sc.cfl_direction = 0.8, "vertical"
    qj, auxj = node_major(sc)
    T_ref = jax_hs.model.aux_get(auxj, "ref_state.T")
    c = jtd.soundspeed_air(jax_hs.model.param_set, T_ref)
    dx = jax_min_node_distance(jax_hs.grid, "vertical")
    expected = 0.8 / float(jnp.max(c * 1.0 / dx))
    cb = cbs.AdaptTimestep(sc, every_steps=1)
    assert abs(cb.new_dt(sc.q, sc.aux) - expected) <= TOL * expected
    with caplog.at_level(logging.INFO, logger="climatemachine"):
        adapt(cb.make(), sc.q, sc.aux)
    assert sc.solver.dt == cb.new_dt(sc.q, sc.aux)
    assert any("updating time step" in r.getMessage()
               for r in caplog.records)
    # the JAX callback on the JAX IMEX type: its linear model has neither
    # the AtmosModel's state accessors nor its thermo
    scj = type("SC", (), {})()
    scj.dg = type("DG", (), dict(grid=jax_hs.grid,
                                 balance_law=jax_hs.model))()
    scj.cfl, scj.cfl_direction = 0.8, "vertical"
    scj.ode_solver_type = JaxIMEXSolverType()
    scj.solver = type("S", (), dict(dt=123.0))()
    with pytest.raises(AttributeError, match="LinearModel' object has no "
                       "attribute"):
        adapt(jcbs.AdaptTimestep(scj, every_steps=1).make(), qj, auxj)
    # one step at the new dt: the column solver keeps its factors alone
    sc.solver.step(sc.q, sc.aux, 0.0)
    gammas = {float(sc.solver.A_im[i, i]) for i in range(sc.solver.nstages)}
    assert set(sc.solver.solver._cached) == {g * sc.solver.dt
                                             for g in gammas - {0.0}}


def test_monitor_courant_against_jax(jax_hs, caplog):
    sc = hs()
    qj, auxj = node_major(sc)
    mon = cbs.MonitorCourant(sc.dg.grid, sc.dg.balance_law, 3.0,
                             every_steps=1)
    got = mon.numbers(sc.q, sc.aux)
    for g, local in zip(got, (jcourant.advective_courant,
                              jcourant.nondiffusive_courant)):
        ref = float(jcourant.courant(local, jax_hs.model, jax_hs.grid, qj,
                                     auxj, 3.0))
        assert abs(g - ref) <= TOL * abs(ref)
    with caplog.at_level(logging.INFO, logger="climatemachine"):
        cb = mon.make()
        cb.init(State(sc.q, sc.aux, 0))
        cb.call(State(sc.q, sc.aux, 1))
    assert mon.last == got
    assert any(r.getMessage().startswith("courant: advective")
               for r in caplog.records)


def test_monitors_through_invoke(settings):
    """The interval settings that ``invoke`` now takes: the monitors run,
    the timestep monitor's samples are per step, and a NaN lane is
    named."""
    cm.init(show_updates="never", checkpoint_dir=str(settings),
            monitor_timestep_duration="2steps",
            monitor_courant_numbers="2steps", adapt_timestep="2steps")
    sc = hs(timeend=4 * DT["explicit"])
    cm.invoke(sc)
    assert bool(torch.isfinite(sc.q).all())
    mon = cbs.MonitorTimestepDuration(every_steps=2)
    cb = mon.make()
    for step in range(5):
        cb.call(State(sc.q, sc.aux, step)) if step else cb.init(
            State(sc.q, sc.aux, 0))
    assert len(mon.samples) == 1 and all(math.isfinite(s) and s >= 0
                                         for s in mon.samples)
    bad = sc.q.clone()
    bad[0, 4, 0] = float("nan")
    assert cbs.show_not_finite_fields(sc.dg.balance_law.prog_spec, bad,
                                      "q") == ["rhoe"]


@pytest.mark.parametrize("interval", ["2steps", "2ssecs"])
def test_timestep_monitor_per_step(monkeypatch, interval):
    """On a step and on a simulated-time interval alike, each sample is
    the wall time since the last firing over the steps since it: a
    clock that moves 10 s a step gives 10 s a step, not the interval's
    20 s."""
    from climatemachine_tpu_torch.driver import driver
    clock = {"now": 0.0}
    monkeypatch.setattr(cbs.time, "monotonic", lambda: clock["now"])
    mons = []

    def make(n):
        mons.append(cbs.MonitorTimestepDuration(every_steps=n))
        return mons[-1].make()

    cb = driver._every(interval, 1.0, make)
    q = torch.zeros(1, 1, 1, dtype=torch.float64)
    cb.init(State(q, None, 0))
    for step in range(1, 7):
        clock["now"] = 10.0 * step
        cb.call(State(q, None, step, float(step)))
    assert mons[0].samples == [10.0, 10.0]
