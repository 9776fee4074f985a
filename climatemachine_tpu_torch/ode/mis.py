"""Multirate Infinitesimal Step methods (port of
``climatemachine_tpu/ode/mis.py``: MultirateInfinitesimalStep :20-103 and
the tableaus MIS2 :113, MIS3C :124, MISRK3 :135; Knoth & Wensch 2014,
Wicker & Skamarock 2002).

Each slow stage i solves an inner fast ODE

    z' = f_fast(z, a + b·τ) + offset,  τ ∈ [0, d_i·dt]

from z(0) = yn + Σ_j α_ij (Z_j − yn), with
offset = Σ_j (γ_ij / (d_i·dt)) (Z_j − yn) + Σ_j (β_ij / d_i) f_slow(Z_j),
in ⌈nsubsteps · d_i⌉ steps of ``fast_method``.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


class MultirateInfinitesimalStep:
    """``slow_rhs`` and ``fast_rhs`` map (q, aux, t) to (dq, aux);
    ``fast_method(rhs, dτ)`` builds the fast integrator (an object with
    ``step(z, aux, τ)``).  The fast integrator of a stage is a host object
    (its tableau and the stage's closure); nothing is built on the
    state's device per stage but the stage's offset.  ``dt_fixed``: the
    step does not adapt dt."""

    def __init__(self, slow_rhs: Callable, fast_rhs: Callable,
                 fast_method: Callable, nsubsteps: int, alpha, beta, gamma,
                 dt: float):
        self.slow_rhs = slow_rhs
        self.fast_rhs = fast_rhs
        self.fast_method = fast_method
        self.nsubsteps = int(nsubsteps)
        self.dt = float(dt)
        self.dt_fixed = True

        a = np.asarray(alpha, dtype=np.float64)
        b = np.asarray(beta, dtype=np.float64).copy()
        g = np.asarray(gamma, dtype=np.float64).copy()
        s = a.shape[0]
        d = b.sum(axis=1)
        c = np.zeros(s)
        for i in range(s):
            c[i] = d[i]
            if i > 0:
                c[i] += sum((a[i, j] + g[i, j]) * c[j] for j in range(i))
            if abs(d[i]) > 1e-10:
                b[i, :] /= d[i]
                g[i, :] /= d[i]
        self.alpha, self.beta, self.gamma = a, b, g
        self.d, self.c, self.ctil = d, c, a @ c
        self.nstages = s

    def step(self, q, aux, t: float):
        """One step from (q, aux) at time t; returns (q', aux')."""
        dt = self.dt
        a, b, g = (m.tolist() for m in (self.alpha, self.beta, self.gamma))
        d, c, ctil = self.d.tolist(), self.c.tolist(), self.ctil.tolist()
        yn = q
        dY, fY = {}, {}          # Z_j − yn and the slow tendency at Z_j
        Z = q
        for i in range(1, self.nstages):
            f, aux = self.slow_rhs(Z, aux, t + c[i - 1] * dt)
            fY[i - 1] = f
            dY[i - 1] = Z - yn

            z0 = yn
            for j in range(1, i):
                if a[i][j]:
                    z0 = z0 + a[i][j] * dY[j]
            offset = None
            for j in range(i):
                part = None
                if j >= 1 and g[i][j]:
                    part = (g[i][j] / dt) * dY[j]
                if b[i][j]:
                    part = (b[i][j] * fY[j] if part is None
                            else part + b[i][j] * fY[j])
                if part is not None:
                    offset = part if offset is None else offset + part

            if abs(d[i]) < 1e-10:
                Z = z0 if offset is None else z0 + dt * offset
                continue

            nsub = max(int(math.ceil(self.nsubsteps * d[i])), 1)
            dtau = d[i] * dt / nsub
            t_a = t + ctil[i] * dt
            t_b = (c[i] - ctil[i]) / d[i]

            def rhs(z, ax, tau, _off=offset, _ta=t_a, _tb=t_b):
                fz, ax = self.fast_rhs(z, ax, _ta + _tb * tau)
                return (fz if _off is None else fz + _off), ax

            fast = self.fast_method(rhs, dtau)
            ztau, tau = z0, 0.0
            for _ in range(nsub):
                ztau, aux = fast.step(ztau, aux, tau)
                tau += dtau
            Z = ztau
        return Z, aux


def _mis(alpha, beta, gamma):
    def ctor(slow_rhs, fast_rhs, fast_method, nsubsteps, dt):
        return MultirateInfinitesimalStep(slow_rhs, fast_rhs, fast_method,
                                          nsubsteps, alpha, beta, gamma, dt)
    return ctor


MIS2 = _mis(
    alpha=[[0, 0, 0, 0], [0, 0, 0, 0],
           [0, 0.536946566710, 0, 0],
           [0, 0.480892968551, 0.500561163566, 0]],
    beta=[[0, 0, 0, 0],
          [0.126848494553, 0, 0, 0],
          [-0.784838278826, 1.37442675268, 0, 0],
          [-0.0456727081749, -0.00875082271190, 0.524775788629, 0]],
    gamma=[[0, 0, 0, 0], [0, 0, 0, 0],
           [0, 0.652465126004, 0, 0],
           [0, -0.0732769849457, 0.144902430420, 0]])

MIS3C = _mis(
    alpha=[[0, 0, 0, 0], [0, 0, 0, 0],
           [0, 0.589557277145, 0, 0],
           [0, 0.544036601551, 0.565511042564, 0]],
    beta=[[0, 0, 0, 0],
          [0.397525189225, 0, 0, 0],
          [-0.227036463644, 0.624528794618, 0, 0],
          [-0.00295238076840, -0.270971764284, 0.671323159437, 0]],
    gamma=[[0, 0, 0, 0], [0, 0, 0, 0],
           [0, 0.142798786398, 0, 0],
           [0, -0.0428918957402, 0.0202720980282, 0]])

MISRK3 = _mis(
    alpha=np.zeros((4, 4)),
    beta=[[0, 0, 0, 0],
          [1.0 / 3.0, 0, 0, 0],
          [0, 0.5, 0, 0],
          [0, 0, 1.0, 0]],
    gamma=np.zeros((4, 4)))
