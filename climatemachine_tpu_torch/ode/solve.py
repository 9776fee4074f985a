"""The time-integration loop (port of ``climatemachine_tpu/ode/solve.py``:
``SolveState`` :21 and ``solve`` :88-168).

State and aux stay var-major on every path, so the JAX package's
``to_internal``/``from_internal`` (:70-86) come down to the var-major
RHS's ``export_aux``: :class:`SolveState` hands callbacks aux with the
lanes that RHS defers refreshed, lazily.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence


class SolveState:
    """Loop state handed to callbacks: ``q``, ``aux``, ``t``, ``step``.
    With the var-major RHS ``vm`` (``solver.vm``) ``aux`` is refreshed by
    its ``export_aux`` on first access after a step; ``q`` and ``aux``
    may be assigned (a callback's projection of the state)."""

    def __init__(self, q, aux, t, step, vm=None):
        self._vm = vm
        self.set_internal(q, aux, t, step)

    def set_internal(self, q, aux, t, step):
        self.q, self._auxi, self.t, self.step = q, aux, t, step
        self._aux = None if self._vm is not None else aux

    @property
    def aux(self):
        if self._aux is None:
            self._aux = self._vm.export_aux(self.q, self._auxi)
        return self._aux

    @aux.setter
    def aux(self, value):
        self._aux = self._auxi = value


def solve(q, aux, solver, timeend: float, t0: float = 0.0,
          callbacks: Sequence = (), numberofsteps: Optional[int] = None,
          adjustfinalstep: bool = True) -> SolveState:
    """Advance (q, aux) from t0 to ``timeend`` with ``solver.step``.

    ``callbacks`` are objects with optional ``init(state)``, ``call(state)
    -> stop`` and ``fini(state)``.  A callback that changes ``solver.dt``
    re-derives the remaining step count; with ``adjustfinalstep`` a last
    step that would pass ``timeend`` is shortened to end on it.  Returns
    the final :class:`SolveState`."""
    dt = solver.dt
    if numberofsteps is None:
        numberofsteps = int(math.ceil((timeend - t0) / dt - 1e-12))
    state = SolveState(q, aux, t0, 0, vm=getattr(solver, "vm", None))
    for cb in callbacks:
        if hasattr(cb, "init"):
            cb.init(state)

    t = t0
    istep = 0
    adapted = False
    while istep < numberofsteps:
        if solver.dt != dt:
            adapted = True
            dt = solver.dt
            numberofsteps = istep + int(
                math.ceil((timeend - t) / dt - 1e-12))
        step_dt = dt
        if adjustfinalstep and t + dt > timeend:
            step_dt = timeend - t
            solver.dt = step_dt
            q, aux = solver.step(state.q, state._auxi, t)
            solver.dt = dt
        else:
            q, aux = solver.step(state.q, state._auxi, t)
        if adjustfinalstep:
            t = min(t + step_dt, timeend)
        elif adapted:
            t = t + step_dt
        else:
            # drift-free for a fixed dt
            t = t0 + (istep + 1) * dt
        state.set_internal(q, aux, t, istep + 1)

        stop = False
        for cb in callbacks:
            if hasattr(cb, "call") and cb.call(state):
                stop = True
        if stop or t >= timeend - 1e-12 * max(1.0, abs(timeend)):
            break
        istep += 1

    for cb in callbacks:
        if hasattr(cb, "fini"):
            cb.fini(state)
    return state
