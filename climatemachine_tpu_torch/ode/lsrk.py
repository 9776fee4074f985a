"""Low-storage 2N Runge-Kutta (port of ``climatemachine_tpu/ode/lsrk.py``:
LowStorageRungeKutta2N :25 with ``pre_stage`` :35-51, LSRKEulerMethod
:63, LSRK54CarpenterKennedy :69, LSRK144NiegemannDiehlBusch :89).

Tableaus from Carpenter & Kennedy (1994), NASA TM-109112, and Niegemann,
Diehl & Busch (2012), J. Comput. Phys. 231(2).
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


def LSRKEulerMethod(rhs: Callable, dt: float,
                    post_step: Optional[Callable] = None,
                    pre_stage: Optional[Callable] = None):
    """Forward Euler in the 2N form."""
    return LowStorageRungeKutta2N(rhs, dt, (0.0,), (1.0,), (0.0,),
                                  post_step=post_step, pre_stage=pre_stage)


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


def LSRK144NiegemannDiehlBusch(rhs: Callable, dt: float,
                               post_step: Optional[Callable] = None,
                               pre_stage: Optional[Callable] = None):
    """14-stage 4th-order scheme of Niegemann, Diehl and Busch, with a
    large stability region along the imaginary axis."""
    A = (0.0,
         -0.7188012108672410,
         -0.7785331173421570,
         -0.0053282796654044,
         -0.8552979934029281,
         -3.9564138245774565,
         -1.5780575380587385,
         -2.0837094552574054,
         -0.7483334182761610,
         -0.7032861106563359,
         0.0013917096117681,
         -0.0932075369637460,
         -0.9514200470875948,
         -7.1151571693922548)
    B = (0.0367762454319673,
         0.3136296607553959,
         0.1531848691869027,
         0.0030097086818182,
         0.3326293790646110,
         0.2440251405350864,
         0.3718879239592277,
         0.6204126221582444,
         0.1524043173028741,
         0.0760894927419266,
         0.0077604214040978,
         0.0024647284755382,
         0.0780348340049386,
         5.5059777270269628)
    C = (0.0,
         0.0367762454319673,
         0.1249685262725025,
         0.2446177702277698,
         0.2476149531070420,
         0.2969311120382472,
         0.3978149645802642,
         0.5270854589440328,
         0.6981269994175695,
         0.8190890835352128,
         0.8527059887098624,
         0.8604711817462826,
         0.8627060376969976,
         0.8734213127600976)
    return LowStorageRungeKutta2N(rhs, dt, A, B, C, post_step=post_step,
                                  pre_stage=pre_stage)
