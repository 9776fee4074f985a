"""Driver callbacks (port of ``climatemachine_tpu/driver/callbacks.py``:
``EveryXSimulationSteps`` :27, ``EveryXSimulationTime`` :47,
``EveryXWallTimeSeconds`` :68, ``AtInit`` :86, ``SummaryLog`` :109 and
``ConservationCheck`` :135).  The Courant monitor, the timestep monitor,
``AdaptTimestep`` and the checkpoint callback are not ported: ``invoke``
refuses a setting that asks for one.

A callback has optional ``init(state)``, ``call(state) -> stop`` and
``fini(state)`` (ode/solve.py); ``state`` holds var-major ``q`` and
``aux``, ``t`` and ``step``.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from typing import Callable

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
