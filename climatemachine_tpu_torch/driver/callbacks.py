"""Driver callbacks (port of ``climatemachine_tpu/driver/callbacks.py``:
``EveryXSimulationSteps`` :27, ``EveryXSimulationTime`` :47,
``EveryXWallTimeSeconds`` :68, ``AtInit`` :86, ``SummaryLog`` :109,
``ConservationCheck`` :135, ``MonitorCourant`` :165, ``AdaptTimestep``
:189, ``show_not_finite_fields`` :219, ``MonitorTimestepDuration`` :234
and ``CheckpointCallback`` :259).

A callback has optional ``init(state)``, ``call(state) -> stop`` and
``fini(state)`` (ode/solve.py); ``state`` holds var-major ``q`` and
``aux``, ``t`` and ``step``.
"""

from __future__ import annotations

import logging
import math
import statistics
import time
from dataclasses import dataclass
from typing import Callable

import torch

from climatemachine_tpu_torch.dg.courant import (advective_courant,
                                                 calculate_dt, courant,
                                                 nondiffusive_courant)
from climatemachine_tpu_torch.dg.reductions import norm, weightedsum

logger = logging.getLogger("climatemachine")


class EveryXSimulationSteps:
    """Fire ``fn(state)`` every ``nsteps`` steps."""

    def __init__(self, fn: Callable, nsteps: int):
        self.fn = fn
        self.nsteps = int(nsteps)

    def init(self, state):
        self._last = state.step

    def call(self, state):
        if state.step - self._last >= self.nsteps:
            self._last = state.step
            return bool(self.fn(state) or False)
        return False


class EveryXSimulationTime:
    """Fire ``fn(state)`` every ``dt_sim`` seconds of simulated time."""

    def __init__(self, fn: Callable, dt_sim: float):
        self.fn = fn
        self.dt_sim = float(dt_sim)

    def init(self, state):
        self._next = state.t + self.dt_sim

    def call(self, state):
        if state.t >= self._next - 1e-12:
            while self._next <= state.t + 1e-12:
                self._next += self.dt_sim
            return bool(self.fn(state) or False)
        return False


class EveryXWallTimeSeconds:
    """Fire ``fn(state)`` every ``dt_wall`` seconds of wall clock."""

    def __init__(self, fn: Callable, dt_wall: float):
        self.fn = fn
        self.dt_wall = float(dt_wall)

    def init(self, state):
        self._next = time.monotonic() + self.dt_wall

    def call(self, state):
        if time.monotonic() >= self._next:
            self._next = time.monotonic() + self.dt_wall
            return bool(self.fn(state) or False)
        return False


class AtInit:
    """``inner``, and its ``fn`` once more at init."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, state):
        if hasattr(self.inner, "init"):
            self.inner.init(state)
        self.inner.fn(state)

    def call(self, state):
        return self.inner.call(state)

    def fini(self, state):
        if hasattr(self.inner, "fini"):
            self.inner.fini(state)


@dataclass
class SummaryLog:
    """Log step, simulated time, run time and norm(Q) every
    ``every_steps`` steps; a norm that is not finite stops the run."""
    grid: object
    every_steps: int = 100

    def make(self):
        t0 = {"wall": None}

        def fn(state):
            if t0["wall"] is None:
                t0["wall"] = time.monotonic()
            n = float(norm(self.grid, state.q))
            logger.info(
                "step %d  simtime %.3e  runtime %.1fs  norm(Q) %.8e",
                state.step, state.t, time.monotonic() - t0["wall"], n)
            if not math.isfinite(n):
                logger.error("norm(Q) is not finite — aborting")
                return True

        return EveryXSimulationSteps(fn, self.every_steps)


@dataclass
class ConservationCheck:
    """Stop the run when ∫ ``varname`` dV drifts from its value at init
    by more than ``error_threshold`` (relative), checked at init and
    every ``every_steps`` steps."""
    grid: object
    model: object
    varname: str = "rho"
    error_threshold: float = 1e-7
    every_steps: int = 100

    def make(self):
        ref = {}
        sl = self.model.prog_spec.index(self.varname).start

        def fn(state):
            total = float(weightedsum(self.grid, state.q, sl))
            if "v0" not in ref:
                ref["v0"] = total
                return
            delta = abs(total - ref["v0"]) / abs(ref["v0"])
            if delta > self.error_threshold:
                logger.error("conservation violation in %s: δ=%.3e",
                             self.varname, delta)
                return True

        return AtInit(EveryXSimulationSteps(fn, self.every_steps))


@dataclass
class MonitorCourant:
    """Log the advective and the non-diffusive (acoustic) Courant numbers
    of the state at ``dt`` every ``every_steps`` steps; ``last`` holds the
    latest pair."""
    grid: object
    model: object
    dt: float
    every_steps: int = 100

    def numbers(self, q, aux):
        """(advective, non-diffusive) Courant numbers of (q, aux)."""
        return (courant(advective_courant, self.model, self.grid, q, aux,
                        self.dt),
                courant(nondiffusive_courant, self.model, self.grid, q, aux,
                        self.dt))

    def make(self):
        def fn(state):
            ca, cn = self.last = self.numbers(state.q, state.aux)
            logger.info("courant: advective %.3f acoustic %.3f", ca, cn)

        return EveryXSimulationSteps(fn, self.every_steps)


@dataclass
class AdaptTimestep:
    """Every ``every_steps`` steps, dt from the configuration's Courant
    number and direction on the solver type's dt model
    (``getdtmodel``: the balance law, or the IMEX type's linear model);
    ``solver.dt`` takes it unless it is within ``rtol`` of the dt in
    force (``solve`` re-derives the step count, the IMEX step factors
    at the new dt and drops the old factors)."""
    solver_config: object
    every_steps: int = 100
    rtol: float = 1e-3

    def new_dt(self, q, aux) -> float:
        sc = self.solver_config
        dtmodel = sc.dg.balance_law
        if getattr(sc, "ode_solver_type", None) is not None:
            dtmodel = sc.ode_solver_type.getdtmodel(dtmodel)
        return float(calculate_dt(sc.dg.grid, dtmodel, q, aux, sc.cfl,
                                  sc.cfl_direction))

    def make(self):
        sc = self.solver_config

        def fn(state):
            ndt = self.new_dt(state.q, state.aux)
            if abs(ndt - sc.solver.dt) <= self.rtol * sc.solver.dt:
                return
            logger.info("updating time step: %.16g => %.16g",
                        sc.solver.dt, ndt)
            sc.solver.dt = ndt

        return EveryXSimulationSteps(fn, self.every_steps)


def show_not_finite_fields(spec, arr, label=""):
    """Log the count of non-finite values of each lane of var-major
    ``arr`` ``[E, n, Np]`` named by ``spec``; returns the lanes' names
    that have any."""
    bad_counts = (~torch.isfinite(arr)).sum(dim=(0, 2)).tolist()
    bad = []
    for name, n_bad in zip(spec.flattened_names(), bad_counts):
        if n_bad:
            logger.warning("%s: field %s has %d non-finite values", label,
                           name, n_bad)
            bad.append(name)
    return bad


@dataclass
class MonitorTimestepDuration:
    """Wall time per step between firings (every ``every_steps`` steps,
    or on a time interval behind the driver's interval callback): the
    time since the last firing over the steps since it, the card
    synchronised first (``torch.cuda.synchronize`` on the state's device;
    no copy to the host); logs the last, median and largest.  The samples
    (seconds a step) are in ``samples``."""
    every_steps: int = 100

    def make(self):
        last = {"time": None, "step": None}
        self.samples = []

        def fn(state):
            if state.q.is_cuda:
                torch.cuda.synchronize(state.q.device)
            now = time.monotonic()
            if last["time"] is not None and state.step > last["step"]:
                per = (now - last["time"]) / (state.step - last["step"])
                self.samples.append(per)
                logger.info(
                    "timestep duration: last %.3f ms  median %.3f ms  "
                    "max %.3f ms", 1e3 * per,
                    1e3 * statistics.median(self.samples),
                    1e3 * max(self.samples))
            last["time"], last["step"] = now, state.step

        return EveryXSimulationSteps(fn, self.every_steps)


@dataclass
class CheckpointCallback:
    """A checkpoint of run ``name`` in ``directory`` every ``every_steps``
    steps, numbered from 0; with ``keep_one`` each new one removes the
    one before (driver/checkpoint.py)."""
    directory: str
    name: str
    every_steps: int = 1000
    keep_one: bool = True

    def make(self):
        from climatemachine_tpu_torch.driver import checkpoint as cp
        counter = {"num": 0}

        def fn(state):
            cp.write_checkpoint(self.directory, self.name, counter["num"],
                                state.q, state.aux, state.t, state.step)
            if self.keep_one and counter["num"] > 0:
                cp.rm_checkpoint(self.directory, self.name,
                                 counter["num"] - 1)
            counter["num"] += 1

        return EveryXSimulationSteps(fn, self.every_steps)
