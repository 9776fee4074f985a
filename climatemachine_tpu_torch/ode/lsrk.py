"""Low-storage 2N Runge-Kutta (port of ``climatemachine_tpu/ode/lsrk.py``:
LowStorageRungeKutta2N :25 with ``pre_stage`` :35-51,
LSRK54CarpenterKennedy :69).

Tableau from Carpenter & Kennedy (1994), NASA TM-109112.
"""

from __future__ import annotations

from typing import Callable, Optional


class LowStorageRungeKutta2N:
    """2N-storage RK: dQ = A_s dQ + dt f(Q); Q += B_s dt dQ.

    ``pre_stage(q, aux, t) -> q`` projects the state before every RHS
    evaluation, and the stage continues from the projected state (the
    generic DG operator's ``pre_stage``); ``post_step(q, aux) -> q`` runs
    once after the last stage (the Held-Suarez every-step filter).
    ``nstages`` counts the stages; ``dt_fixed``: the step does not adapt
    dt."""

    def __init__(self, rhs: Callable, dt: float, A, B, C,
                 post_step: Optional[Callable] = None,
                 pre_stage: Optional[Callable] = None):
        self.rhs = rhs
        self.dt = float(dt)
        self.A = tuple(float(a) for a in A)
        self.B = tuple(float(b) for b in B)
        self.C = tuple(float(c) for c in C)
        self.nstages = len(self.A)
        self.dt_fixed = True
        self.post_step = post_step
        self.pre_stage = pre_stage

    def step(self, q, aux, t: float):
        """One step from (q, aux) at time t; returns (q', aux')."""
        dt = self.dt
        dq = None
        for A, B, C in zip(self.A, self.B, self.C):
            if self.pre_stage is not None:
                q = self.pre_stage(q, aux, t + C * dt)
            tend, aux = self.rhs(q, aux, t + C * dt)
            dq = tend if dq is None else A * dq + tend
            q = q + (B * dt) * dq
        if self.post_step is not None:
            q = self.post_step(q, aux)
        return q, aux


def LSRK54CarpenterKennedy(rhs: Callable, dt: float,
                           post_step: Optional[Callable] = None,
                           pre_stage: Optional[Callable] = None):
    """5-stage 4th-order Carpenter-Kennedy scheme."""
    A = (0.0,
         -567301805773.0 / 1357537059087.0,
         -2404267990393.0 / 2016746695238.0,
         -3550918686646.0 / 2091501179385.0,
         -1275806237668.0 / 842570457699.0)
    B = (1432997174477.0 / 9575080441755.0,
         5161836677717.0 / 13612068292357.0,
         1720146321549.0 / 2090206949498.0,
         3134564353537.0 / 4481467310338.0,
         2277821191437.0 / 14882151754819.0)
    C = (0.0,
         1432997174477.0 / 9575080441755.0,
         2526269341429.0 / 6820363962896.0,
         2006345519317.0 / 3224310063776.0,
         2802321613138.0 / 2924317926251.0)
    return LowStorageRungeKutta2N(rhs, dt, A, B, C, post_step=post_step,
                                  pre_stage=pre_stage)
