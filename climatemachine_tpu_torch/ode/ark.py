"""Additive (IMEX) Runge-Kutta (port of ``climatemachine_tpu/ode/ark.py``:
AdditiveRungeKutta :27-88 with ``_factors``, ``_step_impl`` :90-160 and
``_step_blocks`` :162-230, and the tableau ARK2GiraldoKellyConstantinescu
:251-266).

dQ/dt = f_ex(Q) + f_im(Q) with f_im linear (the HEVI vertical
operator); the implicit tableau is an ESDIRK with one diagonal γ, so one
columnwise factorization serves every implicit stage.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np


class AdditiveRungeKutta:
    """Split explicit-implicit ARK: f_ex = ``rhs_explicit(q, aux, t) ->
    (dq, aux)`` (the fused full − linear remainder), f_im =
    ``rhs_implicit`` (linear in q), and ``solver`` a column solver whose
    ``solve(rhs, α·dt, factors)`` applies (I − α·dt·L)⁻¹
    (``prefactorize`` and ``op_args`` as the column solvers have them).

    :meth:`step` takes the block-layout stage loop (``_step_blocks``)
    when the solver has an exact linear solve in block layout
    (``solve_blocks``, ``apply_op_blocks``, ``layout``) and takes its
    implicit tendencies from the assembled operator (``implied_g``
    "op", the default); otherwise the grid-layout loop (``_step_impl``),
    whose implicit tendency after a solve is, by the solver's
    ``implied_g``: "op", the assembled operator ``apply_op``; "identity",
    (Qi − rhs)/(γ·dt) (the JAX package keeps it to float64: in float32
    it blew up within 50 steps at bench width); "dg", ``rhs_implicit``.

    ``rhs_full`` (the full RHS, F' = f_ex + f_im), when set, takes the
    place of ``rhs_explicit`` on the block loop: the stage algebra absorbs
    the split,

        rhs_i = q + dt Σ a_ex[i,j]·F'_j + dt Σ (a_im[i,j] − a_ex[i,j])·G_j
        out   = q + dt Σ B_i·F'_i              (G cancels: B_ex = B_im).

    ``post_step(q, aux) -> q`` runs once after the last stage."""

    def __init__(self, rhs_explicit, rhs_implicit, solver, dt, A_ex, A_im,
                 B, C, rhs_full: Optional[Callable] = None,
                 post_step: Optional[Callable] = None):
        self.rhs_ex = rhs_explicit
        self.rhs_im = rhs_implicit
        self.solver = solver
        self.dt = float(dt)
        self.A_ex = np.asarray(A_ex, dtype=np.float64)
        self.A_im = np.asarray(A_im, dtype=np.float64)
        self.B = np.asarray(B, dtype=np.float64)
        self.C = np.asarray(C, dtype=np.float64)
        self.nstages = len(self.B)
        self.rhs_full = rhs_full
        self.post_step = post_step

    def _factors(self):
        """{γ: the solver's factorization of (I − γ·dt·L)} at the dt in
        force; the solver drops the factorizations of any other dt (a
        restart or an adapted dt changes it)."""
        out = {}
        for i in range(self.nstages):
            g = float(self.A_im[i, i])
            if g and g not in out:
                out[g] = self.solver.prefactorize(g * self.dt)
        drop = getattr(self.solver, "drop_factors", None)
        if drop is not None:
            drop(keep={g * self.dt for g in out})
        return out

    def step(self, q, aux, t: float):
        """One step from (q, aux) at time t; returns (q', aux')."""
        sv = self.solver
        exact = getattr(sv, "exact_linear_solve", False)
        if (exact and getattr(sv, "implied_g", "op") == "op"
                and hasattr(sv, "solve_blocks")):
            return self._step_blocks(q, aux, t, self.dt, self._factors(),
                                     sv.op_args())
        return self._step_impl(q, aux, t, self.dt, self._factors(),
                               sv.op_args() if exact else None)

    def _step_impl(self, q, aux, t, dt, factors, op_args):
        """Stage loop in the grid layout: each implicit stage solves for
        Qi, then f_ex at Qi and the implicit tendency G (class
        docstring)."""
        sv = self.solver
        mode = getattr(sv, "implied_g", "op")
        exact = getattr(sv, "exact_linear_solve", False)
        A_ex, A_im = self.A_ex.tolist(), self.A_im.tolist()
        B, C = self.B.tolist(), self.C.tolist()
        Fs, Gs = [], []
        Qi = q
        for i in range(self.nstages):
            ti = t + C[i] * dt
            G = None
            if i > 0:
                rhs = q
                for j in range(i):
                    if A_ex[i][j]:
                        rhs = rhs + (dt * A_ex[i][j]) * Fs[j]
                    if A_im[i][j]:
                        rhs = rhs + (dt * A_im[i][j]) * Gs[j]
                gamma = A_im[i][i]
                if gamma:
                    Qi = sv.solve(rhs, gamma * dt, factors=factors[gamma])
                    if exact and mode == "op":
                        G = sv.apply_op(Qi, op_args)
                    elif exact and mode == "identity":
                        G = (Qi - rhs) / (gamma * dt)
                else:
                    Qi = rhs
            F, aux = self.rhs_ex(Qi, aux, ti)
            if G is None:
                G, _ = self.rhs_im(Qi, aux, ti)
            Fs.append(F)
            Gs.append(G)
        out = q
        for i in range(self.nstages):
            if B[i]:
                out = out + (dt * B[i]) * (Fs[i] + Gs[i])
        if self.post_step is not None:
            out = self.post_step(out, aux)
        return out, aux

    def _step_blocks(self, q, aux, t, dt, factors, op_args):
        """Stage loop with the implicit tendencies G kept in the solver's
        block layout ``[nv, nb, ncol]``."""
        sv = self.solver
        lay = sv.layout
        rhs_full = self.rhs_full
        # the tableaus as Python floats: a numpy scalar on the left of a
        # tensor product would not stay a tensor
        A_ex, A_im = self.A_ex.tolist(), self.A_im.tolist()
        B, C = self.B.tolist(), self.C.tolist()
        Fs, Gbs = [], []
        Qi = q
        for i in range(self.nstages):
            ti = t + C[i] * dt
            Gb = None
            if i > 0:
                rhs_g = q
                for j in range(i):
                    if A_ex[i][j]:
                        rhs_g = rhs_g + (dt * A_ex[i][j]) * Fs[j]
                rhs_b = lay.to_blocks(rhs_g)
                for j in range(i):
                    cg = (A_im[i][j] - A_ex[i][j]
                          if rhs_full is not None else A_im[i][j])
                    if cg:
                        rhs_b = rhs_b + (dt * cg) * Gbs[j]
                gamma = A_im[i][i]
                if gamma:
                    Qib = sv.solve_blocks(rhs_b, gamma * dt,
                                          factors=factors[float(gamma)])
                    Gb = sv.apply_op_blocks(Qib, op_args)
                    Qi = lay.from_blocks(Qib)
                else:
                    Qi = lay.from_blocks(rhs_b)
            if rhs_full is not None:
                F, aux = rhs_full(Qi, aux, ti)
            else:
                F, aux = self.rhs_ex(Qi, aux, ti)
            if Gb is None:
                Gb = sv.apply_op_blocks(lay.to_blocks(Qi), op_args)
            Fs.append(F)
            Gbs.append(Gb)
        out = q
        Gacc = None
        for i in range(self.nstages):
            if B[i]:
                out = out + (dt * B[i]) * Fs[i]
                if rhs_full is None:
                    g = (dt * B[i]) * Gbs[i]
                    Gacc = g if Gacc is None else Gacc + g
        if Gacc is not None:
            out = out + lay.from_blocks(Gacc)
        if self.post_step is not None:
            out = self.post_step(out, aux)
        return out, aux


def ARK2GiraldoKellyConstantinescu(rhs_ex, rhs_im, solver, dt,
                                   paperversion: bool = False, **kw):
    """2nd-order 3-stage ARK2 (Giraldo, Kelly & Constantinescu 2013);
    ``kw`` goes to :class:`AdditiveRungeKutta`."""
    s2 = math.sqrt(2.0)
    a32 = (3 + 2 * s2) / 6 if paperversion else 0.5
    A_ex = [[0.0, 0.0, 0.0],
            [2 - s2, 0.0, 0.0],
            [1 - a32, a32, 0.0]]
    g = 1 - 1 / s2
    A_im = [[0.0, 0.0, 0.0],
            [g, g, 0.0],
            [1 / (2 * s2), 1 / (2 * s2), g]]
    B = [1 / (2 * s2), 1 / (2 * s2), g]
    C = [0.0, 2 - s2, 1.0]
    return AdditiveRungeKutta(rhs_ex, rhs_im, solver, dt, A_ex, A_im, B, C,
                              **kw)
