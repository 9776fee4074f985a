"""Runge-Kutta schemes of the 3N-storage family (port of
``climatemachine_tpu/ode/lsrk3n.py``: ``ExplicitRungeKutta``,
``LS3NRK44Classic``, ``LS3NRK33Heuns``, ``LowStorageRungeKutta3N``,
``LS3NRK33Heuns3N``).

``ExplicitRungeKutta`` steps from a Butcher tableau, as the JAX package
writes the classical tableaus; ``LowStorageRungeKutta3N`` keeps the
3N-register update order, which the split-explicit coupling schedules
its fast windows by.  ``pre_stage(q, aux, t) -> q`` projects each stage
state before its RHS evaluation, as in ode/lsrk.py.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


class ExplicitRungeKutta:
    """Explicit RK from a Butcher tableau (A, b, c)."""

    def __init__(self, rhs: Callable, dt: float, A, b, c,
                 pre_stage: Optional[Callable] = None):
        self.rhs = rhs
        self.dt = float(dt)
        self.A = np.asarray(A, dtype=np.float64)
        self.b = np.asarray(b, dtype=np.float64)
        self.c = np.asarray(c, dtype=np.float64)
        self.nstages = len(self.b)
        self.dt_fixed = True
        self.pre_stage = pre_stage

    def step(self, q, aux, t: float):
        """One step from (q, aux) at time t; returns (q', aux')."""
        dt = self.dt
        ks = []
        for i in range(self.nstages):
            qi = q
            for j in range(i):
                if self.A[i, j]:
                    qi = qi + float(dt * self.A[i, j]) * ks[j]
            ti = t + float(self.c[i]) * dt
            if self.pre_stage is not None:
                qi = self.pre_stage(qi, aux, ti)
            k, aux = self.rhs(qi, aux, ti)
            ks.append(k)
        out = q
        for i in range(self.nstages):
            if self.b[i]:
                out = out + float(dt * self.b[i]) * ks[i]
        return out, aux


def LS3NRK44Classic(rhs: Callable, dt: float,
                    pre_stage: Optional[Callable] = None):
    """The classical fourth-order RK."""
    A = [[0, 0, 0, 0],
         [0.5, 0, 0, 0],
         [0, 0.5, 0, 0],
         [0, 0, 1.0, 0]]
    return ExplicitRungeKutta(rhs, dt, A, [1 / 6, 1 / 3, 1 / 3, 1 / 6],
                              [0, 0.5, 0.5, 1.0], pre_stage=pre_stage)


def LS3NRK33Heuns(rhs: Callable, dt: float,
                  pre_stage: Optional[Callable] = None):
    """Heun's third-order method."""
    A = [[0, 0, 0],
         [1 / 3, 0, 0],
         [0, 2 / 3, 0]]
    return ExplicitRungeKutta(rhs, dt, A, [0.25, 0.0, 0.75],
                              [0, 1 / 3, 2 / 3], pre_stage=pre_stage)


class LowStorageRungeKutta3N:
    """The 3N-register form; per stage s of n:

        dQ += f(Q, t + C[s] dt)
        Q  += B[s,0] dt dQ + B[s,1] dt dR
        dR += A[(s+1) % n, 1] dQ
        dQ  = A[(s+1) % n, 0] dQ

    ``RKW`` holds the weights the split-explicit coupling reads."""

    def __init__(self, rhs: Callable, dt: float, RKA, RKB, RKC, RKW):
        self.rhs = rhs
        self.dt = float(dt)
        self.RKA = np.asarray(RKA, dtype=np.float64)
        self.RKB = np.asarray(RKB, dtype=np.float64)
        self.RKC = np.asarray(RKC, dtype=np.float64)
        self.RKW = np.asarray(RKW, dtype=np.float64)
        self.nstages = len(self.RKC)
        self.dt_fixed = True

    def step(self, q, aux, t: float):
        dt, n = self.dt, self.nstages
        dq = dr = None
        for s in range(n):
            tend, aux = self.rhs(q, aux, t + float(self.RKC[s]) * dt)
            dq = tend if dq is None else dq + tend
            q = q + float(self.RKB[s, 0] * dt) * dq
            if dr is not None and self.RKB[s, 1]:
                q = q + float(self.RKB[s, 1] * dt) * dr
            a2 = float(self.RKA[(s + 1) % n, 1])
            if a2:
                dr = a2 * dq if dr is None else dr + a2 * dq
            dq = float(self.RKA[(s + 1) % n, 0]) * dq
        return q, aux


def LS3NRK33Heuns3N(rhs: Callable, dt: float):
    """Heun's third-order method in the 3N-register form."""
    return LowStorageRungeKutta3N(
        rhs, dt,
        RKA=[[0.0, 0.0], [0.0, 1.0], [-1.0, 1.0 / 3.0]],
        RKB=[[1.0 / 3.0, 0.0], [2.0 / 3.0, -1.0 / 3.0],
             [3.0 / 4.0, 1.0 / 4.0]],
        RKC=[0.0, 1.0 / 3.0, 2.0 / 3.0],
        RKW=[1.0 / 4.0, 0.0, 3.0 / 4.0])
