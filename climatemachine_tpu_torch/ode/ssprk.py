"""Strong-stability-preserving Runge-Kutta (port of
``climatemachine_tpu/ode/ssprk.py``: StrongStabilityPreservingRungeKutta
:13-29, SSPRK22Heuns :32, SSPRK22Ralstons :42, SSPRK33ShuOsher :52 and
SSPRK34SpiteriRuuth :58).

Stage s: Q_s = a1_s·Q_0 + a2_s·Q_{s−1} + b_s·dt·f(Q_{s−1}).  Shu & Osher
(1988) 3 stages, 3rd order; Spiteri & Ruuth (2002) 4 stages, 3rd order.

The methods take no ``pre_stage``, as the JAX package's do not: its
``ExplicitSolverType`` then builds them without the DG operator's
state projection (JAX driver/solver_types.py:52-56), which the port's
type allows only where that projection is the identity.
"""

from __future__ import annotations

from typing import Callable, Optional


class StrongStabilityPreservingRungeKutta:
    """``rhs(q, aux, t) -> (dq, aux)``; ``post_step(q, aux) -> q`` runs
    once after the last stage (the Held-Suarez every-step filter; the
    JAX class has none).  ``dt_fixed``: the step does not adapt dt."""

    def __init__(self, rhs: Callable, dt: float, RKA1, RKA2, RKB, RKC,
                 post_step: Optional[Callable] = None):
        self.rhs = rhs
        self.dt = float(dt)
        self.A1 = tuple(float(a) for a in RKA1)
        self.A2 = tuple(float(a) for a in RKA2)
        self.B = tuple(float(b) for b in RKB)
        self.C = tuple(float(c) for c in RKC)
        self.nstages = len(self.B)
        self.dt_fixed = True
        self.post_step = post_step

    def step(self, q, aux, t: float):
        """One step from (q, aux) at time t; returns (q', aux')."""
        dt = self.dt
        q0 = q
        for a1, a2, b, c in zip(self.A1, self.A2, self.B, self.C):
            tend, aux = self.rhs(q, aux, t + c * dt)
            q = a1 * q0 + a2 * q + (b * dt) * tend
        if self.post_step is not None:
            q = self.post_step(q, aux)
        return q, aux


def SSPRK22Heuns(rhs: Callable, dt: float,
                 post_step: Optional[Callable] = None):
    """Heun's method as the 2-stage SSP RK2."""
    return StrongStabilityPreservingRungeKutta(
        rhs, dt, RKA1=(1.0, 0.5), RKA2=(0.0, 0.5), RKB=(1.0, 0.5),
        RKC=(0.0, 1.0), post_step=post_step)


def SSPRK22Ralstons(rhs: Callable, dt: float,
                    post_step: Optional[Callable] = None):
    """Ralston's 2nd-order method as a 2-stage SSP RK2."""
    return StrongStabilityPreservingRungeKutta(
        rhs, dt, RKA1=(1.0, 5.0 / 8.0), RKA2=(0.0, 3.0 / 8.0),
        RKB=(2.0 / 3.0, 3.0 / 4.0), RKC=(0.0, 2.0 / 3.0),
        post_step=post_step)


def SSPRK33ShuOsher(rhs: Callable, dt: float,
                    post_step: Optional[Callable] = None):
    """The 3-stage 3rd-order scheme of Shu and Osher."""
    return StrongStabilityPreservingRungeKutta(
        rhs, dt, RKA1=(1.0, 3.0 / 4.0, 1.0 / 3.0),
        RKA2=(0.0, 1.0 / 4.0, 2.0 / 3.0), RKB=(1.0, 1.0 / 4.0, 2.0 / 3.0),
        RKC=(0.0, 1.0, 1.0 / 2.0), post_step=post_step)


def SSPRK34SpiteriRuuth(rhs: Callable, dt: float,
                        post_step: Optional[Callable] = None):
    """The 4-stage 3rd-order scheme of Spiteri and Ruuth."""
    return StrongStabilityPreservingRungeKutta(
        rhs, dt, RKA1=(1.0, 0.0, 2.0 / 3.0, 0.0),
        RKA2=(0.0, 1.0, 1.0 / 3.0, 1.0),
        RKB=(1.0 / 2.0, 1.0 / 2.0, 1.0 / 6.0, 1.0 / 2.0),
        RKC=(0.0, 1.0 / 2.0, 1.0, 1.0 / 2.0), post_step=post_step)
