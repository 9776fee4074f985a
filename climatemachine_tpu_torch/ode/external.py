"""An adaptive Dormand-Prince 5(4) stepper behind the framework's step
surface (port of ``climatemachine_tpu/ode/external.py``
``ExternalODESolver`` :37-62, which wraps ``jax.experimental.ode.odeint``).

Each framework step integrates one ``dt`` window with the adaptive
stepper inside, as the JAX package's ``odeint`` does it: the Hairer,
Nørsett & Wanner initial step, the Dormand-Prince tableau with its
embedded 4th-order error estimate, the RMS error ratio against atol +
rtol·max(|y₀|, |y₁|), the step-size controller (safety 0.9, growth ≤
10, shrink ≥ 0.2 after a rejection, exponent −1/5), and the window's end
value from the 4th-order Dormand-Prince interpolant of the last
accepted step.  aux is frozen across the window (the integrand is dq/dt
= f(q, aux, t)); the step's aux comes from one more call at the end.

The accept/reject decision and the step size are the host's: each
attempted step reads its error ratio back from the state's device.  The
JAX package's second backend, ``DiffraxSolver``, wraps a package of its
own and is not ported.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

#: the Dormand-Prince nodes, coefficients, 5th-order weights and error
#: weights (5th − embedded 4th order)
DP_C = (1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
DP_A = ((1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84))
DP_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
DP_E = (35 / 384 - 1951 / 21600, 0.0, 500 / 1113 - 22642 / 50085,
        125 / 192 - 451 / 720, -2187 / 6784 - -12231 / 42400,
        11 / 84 - 649 / 6300, -1.0 / 60.0)
#: the interpolant's midpoint weights
DP_MID = (6025192743 / 30085553152 / 2, 0.0, 51252292925 / 65400821598 / 2,
          -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
          -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2)


def _combine(y0, h: float, coefs, k):
    """y0 + h·Σ coefs_i k_i (the zero coefficients skipped)."""
    acc = None
    for c, ki in zip(coefs, k):
        if c:
            acc = c * ki if acc is None else acc + c * ki
    return y0 + h * acc


def _initial_step(fun, t0: float, y0, f0, order: int, rtol: float,
                  atol: float) -> float:
    """Hairer, Nørsett & Wanner, Solving ODEs I, sec. II.4."""
    scale = atol + y0.abs() * rtol
    d0 = torch.linalg.vector_norm(y0 / scale).item()
    d1 = torch.linalg.vector_norm(f0 / scale).item()
    h0 = 1e-6 if (d0 < 1e-5 or d1 < 1e-5) else 0.01 * d0 / d1
    f1 = fun(y0 + h0 * f0, t0 + h0)
    d2 = torch.linalg.vector_norm((f1 - f0) / scale).item() / h0
    if d1 <= 1e-15 and d2 <= 1e-15:
        h1 = max(1e-6, h0 * 1e-3)
    else:
        h1 = (0.01 / max(d1, d2)) ** (1.0 / (order + 1.0))
    return min(100.0 * h0, h1)


def _optimal_step(h: float, ratio: float, safety: float = 0.9,
                  ifactor: float = 10.0, dfactor: float = 0.2,
                  order: float = 5.0) -> float:
    if ratio == 0:
        return h * ifactor
    dfactor = 1.0 if ratio < 1 else dfactor
    return h * min(ifactor, max(ratio ** (-1.0 / order) * safety, dfactor))


def dopri5(fun: Callable, y0, t0: float, t1: float, rtol: float = 1.4e-8,
           atol: float = 1.4e-8, mxstep: float = math.inf,
           hmax: float = math.inf):
    """y(t1) of y' = fun(y, t) from y(t0) = y0 (t1 > t0) by adaptive
    Dormand-Prince 5(4), as ``jax.experimental.ode.odeint`` computes it
    for the times (t0, t1)."""
    f = fun(y0, t0)
    h = min(max(_initial_step(fun, t0, y0, f, 4, rtol, atol), 0.0), hmax)
    y, t, last_t, i = y0, t0, t0, 0
    last = None                 # (y, y_new, k, h) of the last accepted step
    while t < t1 and i < mxstep and h > 0:
        k = [f]
        for c, a in zip(DP_C, DP_A):
            k.append(fun(_combine(y, h, a, k), t + h * c))
        y_new = _combine(y, h, DP_B, k)
        err = h * sum(c * ki for c, ki in zip(DP_E, k) if c)
        tol = atol + rtol * torch.maximum(y.abs(), y_new.abs())
        ratio = torch.sqrt(torch.mean((err / tol) ** 2)).item()
        h_next = min(max(_optimal_step(h, ratio), 0.0), hmax)
        if ratio <= 1.0:
            last = (y, y_new, k, h)
            y, f, last_t, t = y_new, k[-1], t, t + h
        h, i = h_next, i + 1
    if last is None:
        return y
    # the 4th-order interpolant of the last accepted step at t1
    ya, yb, k, hl = last
    y_mid = _combine(ya, hl, DP_MID, k)
    dy0, dy1 = k[0], k[-1]
    coef = (-2.0 * hl * dy0 + 2.0 * hl * dy1 - 8.0 * ya - 8.0 * yb
            + 16.0 * y_mid,
            5.0 * hl * dy0 - 3.0 * hl * dy1 + 18.0 * ya + 14.0 * yb
            - 32.0 * y_mid,
            -4.0 * hl * dy0 + hl * dy1 - 11.0 * ya - 5.0 * yb + 16.0 * y_mid,
            hl * dy0, ya)
    s = (t1 - last_t) / (t - last_t)
    out = torch.zeros_like(ya)
    for c in coef:
        out = out * s + c
    return out


class ExternalODESolver:
    """Adaptive Dormand-Prince 5(4) (:func:`dopri5`) over each window of
    ``dt``: ``rhs(q, aux, t) -> (dq, aux)`` with aux frozen inside the
    window."""

    def __init__(self, rhs: Callable, dt: float, rtol: float = 1e-8,
                 atol: float = 1e-8, mxstep: int = 10_000):
        self.rhs = rhs
        self.dt = float(dt)
        self.rtol, self.atol, self.mxstep = rtol, atol, mxstep
        self.dt_fixed = True

    def step(self, q, aux, t: float):
        q1 = dopri5(lambda y, s: self.rhs(y, aux, s)[0], q,
                                float(t), float(t) + self.dt, self.rtol,
                                self.atol, self.mxstep)
        _, aux1 = self.rhs(q1, aux, t + self.dt)
        return q1, aux1
