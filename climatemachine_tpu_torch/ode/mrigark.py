"""Multirate infinitesimal GARK methods of Sandu (2019) (port of
``climatemachine_tpu/ode/mrigark.py``: ``_ceil_substeps`` :41,
MRIGARKExplicit :45-102, MRIGARKDecoupledImplicit :105-172 and the
tableaus MRIGARKERK33aSandu :183, MRIGARKERK45aSandu :200,
MRIGARKIRK21aSandu :222, MRIGARKESDIRK34aSandu :238,
MRIGARKESDIRK46aSandu :258).

At slow stage s the fast ODE

    v' = f_fast(v, t) + Σ_j γ̄_sj(τ) R_j,   γ̄_sj(τ) = Σ_k Γk[s,j] τ^k / Δc_s,
    τ  = (t − t_s)/Δt_s,  t ∈ [t_s, t_s + Δc_s·dt]

runs in ⌈nsubsteps · Δc_s⌉ steps of ``fast_method``, with R_j = f_slow(Y_j,
t_j); the τ-polynomial is evaluated inside the fast right-hand side, so
every inner stage sees its own coupling.  The decoupled-implicit variant
follows each fast solve with Q = Q̂ + α f_slow(Q), Q̂ = Q + Σ_j (Σ_k
dt·Γk[2s+1,j]/(k+1)) R_j, α = dt·Γ0[2s+1, s+1], by ``solver.solve(rhs,
α)``, the interface of the IMEX column solvers.
"""

from __future__ import annotations

import math
from fractions import Fraction as Fr
from typing import Callable, Sequence

import numpy as np


def _ceil_substeps(nsubsteps: int, frac: float) -> int:
    return max(int(math.ceil(nsubsteps * frac)), 1)


class _MRIGARK:
    """The fast solve both variants share."""

    def _fast_solve(self, q, aux, s: int, ts: float, dts: float,
                    Rs: tuple):
        """The fast ODE of slow stage s from t_s over Δt_s, the forcing
        Σ_j γ̄_sj(τ)·R_j added in its right-hand side; (v, aux)."""
        def rhs(z, ax, tf):
            tau = (tf - ts) / dts
            f, ax = self.fast_rhs(z, ax, tf)
            for j, Rj in enumerate(Rs):
                f = f + self._coef(s, j, tau) * Rj
            return f, ax

        nsub = _ceil_substeps(self.nsubsteps, self.dc[s])
        dtau = dts / nsub
        fast = self.fast_method(rhs, dtau)
        tf = ts
        for _ in range(nsub):
            q, aux = fast.step(q, aux, tf)
            tf += dtau
        return q, aux


class MRIGARKExplicit(_MRIGARK):
    """Explicit MRI-GARK: ``Gammas`` = (Γ0, Γ1, ...), each a lower
    triangular [Ns, Ns]; Δc_s = Σ_j Γ0[s,j].  ``fast_method(rhs, dτ)``
    builds the fast integrator (a host object) per stage."""

    def __init__(self, slow_rhs: Callable, fast_rhs: Callable,
                 fast_method: Callable, nsubsteps: int,
                 Gammas: Sequence, dt: float):
        self.slow_rhs = slow_rhs
        self.fast_rhs = fast_rhs
        self.fast_method = fast_method
        self.nsubsteps = int(nsubsteps)
        self.dt = float(dt)
        self.dt_fixed = True
        G0 = np.asarray(Gammas[0], dtype=np.float64)
        dc = G0.sum(axis=1)
        # the 1/Δc_s of γ̄ folded into the matrices
        self.Gs = [np.asarray(G, dtype=np.float64) / dc[:, None]
                   for G in Gammas]
        self.dc = dc
        self.nstages = G0.shape[0]

    def _coef(self, s: int, j: int, tau: float) -> float:
        Gs = self.Gs
        sc = float(Gs[-1][s, j])
        for k in range(len(Gs) - 2, -1, -1):
            sc = sc * tau + float(Gs[k][s, j])
        return sc

    def step(self, q, aux, t: float):
        """One step from (q, aux) at time t; returns (q', aux')."""
        dt = self.dt
        Rs = []
        ts = t
        for s in range(self.nstages):
            dts = float(self.dc[s]) * dt
            R, aux = self.slow_rhs(q, aux, ts)
            Rs.append(R)
            q, aux = self._fast_solve(q, aux, s, ts, dts, tuple(Rs))
            ts += dts
        return q, aux


class MRIGARKDecoupledImplicit(_MRIGARK):
    """Decoupled implicit MRI-GARK: ``Gammas`` [2·Ns, Ns + 1]; rows 2s
    couple the fast solve of stage s, rows 2s + 1 (which sum to zero)
    build its implicit correction, solved by ``solver.solve(rhs, α)`` for
    the linear slow operator."""

    def __init__(self, slow_rhs: Callable, fast_rhs: Callable,
                 fast_method: Callable, nsubsteps: int, solver,
                 Gammas: Sequence, dt: float):
        self.slow_rhs = slow_rhs
        self.fast_rhs = fast_rhs
        self.fast_method = fast_method
        self.nsubsteps = int(nsubsteps)
        self.solver = solver
        self.dt = float(dt)
        self.dt_fixed = True
        Gs = [np.asarray(G, dtype=np.float64) for G in Gammas]
        dc_all = Gs[0].sum(axis=1)
        if not np.allclose(dc_all[1::2], 0.0, atol=1e-12):
            raise ValueError("the implicit rows of a decoupled MRI-GARK "
                             "tableau must sum to zero")
        self.dc = dc_all[0::2]
        self.nstages = len(self.dc)
        if Gs[0].shape != (2 * self.nstages, self.nstages + 1):
            raise ValueError(f"Γ0 of shape {Gs[0].shape}: expected "
                             f"{(2 * self.nstages, self.nstages + 1)}")
        self.Gs = Gs

    def _coef(self, s: int, j: int, tau: float) -> float:
        Gs, dc = self.Gs, float(self.dc[s])
        sc = float(Gs[-1][2 * s, j]) / dc
        for k in range(len(Gs) - 2, -1, -1):
            sc = sc * tau + float(Gs[k][2 * s, j]) / dc
        return sc

    def step(self, q, aux, t: float):
        """One step from (q, aux) at time t; returns (q', aux')."""
        dt = self.dt
        Gs = self.Gs
        Rs = []
        ts = t
        for s in range(self.nstages):
            dts = float(self.dc[s]) * dt
            R, aux = self.slow_rhs(q, aux, ts)
            Rs.append(R)
            q, aux = self._fast_solve(q, aux, s, ts, dts, tuple(Rs))
            ts += dts
            qhat = q
            for j, Rj in enumerate(Rs):
                sc = sum(dt * float(Gs[k][2 * s + 1, j]) / (k + 1)
                         for k in range(len(Gs)))
                if sc:
                    qhat = qhat + sc * Rj
            q = self.solver.solve(qhat, dt * float(Gs[0][2 * s + 1, s + 1]))
        return q, aux


def _f(mat) -> np.ndarray:
    return np.array([[float(Fr(*e) if isinstance(e, tuple) else e)
                      for e in row] for row in mat], dtype=np.float64)


def MRIGARKERK33aSandu(slow_rhs, fast_rhs, fast_method, nsubsteps, dt,
                       delta: float = -0.5):
    """3rd-order, 3-stage explicit scheme."""
    d = delta
    G0 = np.array([
        [1 / 3, 0, 0],
        [(-6 * d - 7) / 12, (6 * d + 11) / 12, 0],
        [0, (6 * d - 5) / 12, (3 - 2 * d) / 4]])
    G1 = np.array([
        [0, 0, 0],
        [(2 * d + 1) / 2, -(2 * d + 1) / 2, 0],
        [1 / 2, -(2 * d + 1) / 2, d]])
    return MRIGARKExplicit(slow_rhs, fast_rhs, fast_method, nsubsteps,
                           (G0, G1), dt)


def MRIGARKERK45aSandu(slow_rhs, fast_rhs, fast_method, nsubsteps, dt):
    """4th-order, 5-stage explicit scheme."""
    G0 = _f([
        [(1, 5), 0, 0, 0, 0],
        [(-53, 16), (281, 80), 0, 0, 0],
        [(-36562993, 71394880), (34903117, 17848720),
         (-88770499, 71394880), 0, 0],
        [(-7631593, 71394880), (-166232021, 35697440),
         (6068517, 1519040), (8644289, 8924360), 0],
        [(277061, 303808), (-209323, 1139280), (-1360217, 1139280),
         (-148789, 56964), (147889, 45120)]])
    G1 = _f([
        [0, 0, 0, 0, 0],
        [(503, 80), (-503, 80), 0, 0, 0],
        [(-1365537, 35697440), (4963773, 7139488),
         (-1465833, 2231090), 0, 0],
        [(66974357, 35697440), (21445367, 7139488), -3,
         (-8388609, 4462180), 0],
        [(-18227, 7520), 2, 1, 5, (-41933, 7520)]])
    return MRIGARKExplicit(slow_rhs, fast_rhs, fast_method, nsubsteps,
                           (G0, G1), dt)


def MRIGARKIRK21aSandu(slow_rhs, fast_rhs, fast_method, nsubsteps, solver,
                       dt):
    """2nd-order decoupled implicit scheme with one slow stage."""
    G0 = _f([[1, 0],
             [(-1, 2), (1, 2)]])
    return MRIGARKDecoupledImplicit(slow_rhs, fast_rhs, fast_method,
                                    nsubsteps, solver, (G0,), dt)


def _esdirk_lambda() -> float:
    mu = np.arctan(1.0 / (2 * np.sqrt(2.0))) / 3
    lam = 1 - np.cos(mu) / np.sqrt(2.0) + np.sqrt(1.5) * np.sin(mu)
    if abs(-1 + 9 * lam - 18 * lam ** 2 + 6 * lam ** 3) >= 1e-12:
        raise ArithmeticError("ESDIRK34a's λ is off its cubic")
    return lam


def MRIGARKESDIRK34aSandu(slow_rhs, fast_rhs, fast_method, nsubsteps,
                          solver, dt):
    """3rd-order decoupled implicit scheme with three slow stages."""
    lam = _esdirk_lambda()
    G0 = np.array([
        [1 / 3, 0, 0, 0],
        [-lam, lam, 0, 0],
        [(3 - 10 * lam) / (24 * lam - 6), (5 - 18 * lam) / (6 - 24 * lam),
         0, 0],
        [(-24 * lam ** 2 + 6 * lam + 1) / (6 - 24 * lam),
         (-48 * lam ** 2 + 12 * lam + 1) / (24 * lam - 6), lam, 0],
        [(3 - 16 * lam) / (12 - 48 * lam),
         (48 * lam ** 2 - 21 * lam + 2) / (12 * lam - 3),
         (3 - 16 * lam) / 4, 0],
        [-lam, 0, 0, lam]])
    return MRIGARKDecoupledImplicit(slow_rhs, fast_rhs, fast_method,
                                    nsubsteps, solver, (G0,), dt)


def MRIGARKESDIRK46aSandu(slow_rhs, fast_rhs, fast_method, nsubsteps,
                          solver, dt):
    """4th-order decoupled implicit scheme with five slow stages."""
    G0 = _f([
        [(1, 5), 0, 0, 0, 0, 0],
        [(-1, 4), (1, 4), 0, 0, 0, 0],
        [(1771023115159, 1929363690800), (-1385150376999, 1929363690800),
         0, 0, 0, 0],
        [(914009, 345800), (-1000459, 345800), (1, 4), 0, 0, 0],
        [(18386293581909, 36657910125200), (5506531089, 80566835440),
         (-178423463189, 482340922700), 0, 0, 0],
        [(36036097, 8299200), (4621, 118560), (-38434367, 8299200),
         (1, 4), 0, 0],
        [(-247809665162987, 146631640500800),
         (10604946373579, 14663164050080), (10838126175385, 5865265620032),
         (-24966656214317, 36657910125200), 0, 0],
        [(38519701, 11618880), (10517363, 9682400), (-23284701, 19364800),
         (-10018609, 2904720), (1, 4), 0],
        [(-52907807977903, 33838070884800), (74846944529257, 73315820250400),
         (365022522318171, 146631640500800),
         (-20513210406809, 109973730375600), (-2918009798, 1870301537), 0],
        [(19, 100), (-73, 300), (127, 300), (127, 300), (-313, 300),
         (1, 4)]])
    G1 = _f([
        [0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0],
        [(-1674554930619, 964681845400), (1674554930619, 964681845400),
         0, 0, 0, 0],
        [(-1007739, 172900), (1007739, 172900), 0, 0, 0, 0],
        [(-8450070574289, 18328955062600), (-39429409169, 40283417720),
         (173621393067, 120585230675), 0, 0, 0],
        [(-122894383, 16598400), (14501, 237120), (121879313, 16598400),
         0, 0, 0],
        [(32410002731287, 15434909526400), (-46499276605921, 29326328100160),
         (-34914135774643, 11730531240064), (45128506783177, 18328955062600),
         0, 0],
        [(-128357303, 23237760), (-35433927, 19364800), (71038479, 38729600),
         (8015933, 1452360), 0, 0],
        [(136721604296777, 67676141769600),
         (-349632444539303, 146631640500800),
         (-1292744859249609, 293263281001600), (8356250416309, 54986865187800),
         (17282943803, 3740603074), 0],
        [(3, 25), (-29, 300), (71, 300), (71, 300), (-149, 300), 0]])
    return MRIGARKDecoupledImplicit(slow_rhs, fast_rhs, fast_method,
                                    nsubsteps, solver, (G0, G1), dt)
