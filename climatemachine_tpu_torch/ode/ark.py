"""Additive (IMEX) Runge-Kutta (port of ``climatemachine_tpu/ode/ark.py``:
AdditiveRungeKutta :27-88 with ``_factors``, ``_step_impl`` :90-160 and
``_step_blocks`` :162-230, and the tableaus ARK1ForwardBackwardEuler
:233, ARK2ImplicitExplicitMidpoint :242, ARK2GiraldoKellyConstantinescu
:251, ARK548L2SA2KennedyCarpenter :269, ARK437L2SA1KennedyCarpenter :344
and DBM453VoglEtAl :406).

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

    ``post_step(q, aux) -> q`` runs once after the last stage.

    A solver without ``prefactorize`` (the HEVI type's Newton-Krylov
    column solver) is called as ``solve(rhs, α·dt)``."""

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
        restart or an adapted dt changes it).  None for a solver that
        does not prefactorize."""
        if not hasattr(self.solver, "prefactorize"):
            return None
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
                    Qi = (sv.solve(rhs, gamma * dt) if factors is None else
                          sv.solve(rhs, gamma * dt, factors=factors[gamma]))
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


def ARK1ForwardBackwardEuler(rhs_ex, rhs_im, solver, dt, **kw):
    """IMEX Euler: forward Euler for f_ex, backward for f_im."""
    A_ex = [[0.0, 0.0], [1.0, 0.0]]
    A_im = [[0.0, 0.0], [0.0, 1.0]]
    B = [0.0, 1.0]
    C = [0.0, 1.0]
    return AdditiveRungeKutta(rhs_ex, rhs_im, solver, dt, A_ex, A_im, B, C,
                              **kw)


def ARK2ImplicitExplicitMidpoint(rhs_ex, rhs_im, solver, dt, **kw):
    """IMEX midpoint: explicit and implicit midpoint rules."""
    A_ex = [[0.0, 0.0], [0.5, 0.0]]
    A_im = [[0.0, 0.0], [0.0, 0.5]]
    B = [0.0, 1.0]
    C = [0.0, 0.5]
    return AdditiveRungeKutta(rhs_ex, rhs_im, solver, dt, A_ex, A_im, B, C,
                              **kw)


def ARK548L2SA2KennedyCarpenter(rhs_ex, rhs_im, solver, dt, **kw):
    """8-stage 5th-order ARK5(4)8L[2]SA₂ of Kennedy & Carpenter (2019),
    ESDIRK diagonal γ = 2/9."""
    g = 2.0 / 9.0
    A_im = np.zeros((8, 8))
    A_ex = np.zeros((8, 8))
    A_im[1, 0] = g
    A_im[1, 1] = g
    A_im[2, 0] = 2366667076620.0 / 8822750406821.0
    A_im[2, 1] = 2366667076620.0 / 8822750406821.0
    A_im[2, 2] = g
    A_im[3, 0] = -257962897183.0 / 4451812247028.0
    A_im[3, 1] = -257962897183.0 / 4451812247028.0
    A_im[3, 2] = 128530224461.0 / 14379561246022.0
    A_im[3, 3] = g
    A_im[4, 0] = -486229321650.0 / 11227943450093.0
    A_im[4, 1] = -486229321650.0 / 11227943450093.0
    A_im[4, 2] = -225633144460.0 / 6633558740617.0
    A_im[4, 3] = 1741320951451.0 / 6824444397158.0
    A_im[4, 4] = g
    A_im[5, 0] = 621307788657.0 / 4714163060173.0
    A_im[5, 1] = 621307788657.0 / 4714163060173.0
    A_im[5, 2] = -125196015625.0 / 3866852212004.0
    A_im[5, 3] = 940440206406.0 / 7593089888465.0
    A_im[5, 4] = 961109811699.0 / 6734810228204.0
    A_im[5, 5] = g
    A_im[6, 0] = 2036305566805.0 / 6583108094622.0
    A_im[6, 1] = 2036305566805.0 / 6583108094622.0
    A_im[6, 2] = -3039402635899.0 / 4450598839912.0
    A_im[6, 3] = -1829510709469.0 / 31102090912115.0
    A_im[6, 4] = -286320471013.0 / 6931253422520.0
    A_im[6, 5] = 8651533662697.0 / 9642993110008.0
    A_im[6, 6] = g
    b = [0.0, 0.0, 3517720773327.0 / 20256071687669.0,
         4569610470461.0 / 17934693873752.0,
         2819471173109.0 / 11655438449929.0,
         3296210113763.0 / 10722700128969.0,
         -1142099968913.0 / 5710983926999.0, g]
    A_im[7, :] = b                          # stiffly accurate last row
    A_ex[1, 0] = 4.0 / 9.0
    A_ex[2, 0] = 1.0 / 9.0
    A_ex[2, 1] = 1183333538310.0 / 1827251437969.0
    A_ex[3, 0] = 895379019517.0 / 9750411845327.0
    A_ex[3, 1] = 477606656805.0 / 13473228687314.0
    A_ex[3, 2] = -112564739183.0 / 9373365219272.0
    A_ex[4, 0] = -4458043123994.0 / 13015289567637.0
    A_ex[4, 1] = -2500665203865.0 / 9342069639922.0
    A_ex[4, 2] = 983347055801.0 / 8893519644487.0
    A_ex[4, 3] = 2185051477207.0 / 2551468980502.0
    A_ex[5, 0] = -167316361917.0 / 17121522574472.0
    A_ex[5, 1] = 1605541814917.0 / 7619724128744.0
    A_ex[5, 2] = 991021770328.0 / 13052792161721.0
    A_ex[5, 3] = 2342280609577.0 / 11279663441611.0
    A_ex[5, 4] = 3012424348531.0 / 12792462456678.0
    A_ex[6, 0] = 6680998715867.0 / 14310383562358.0
    A_ex[6, 1] = 5029118570809.0 / 3897454228471.0
    A_ex[6, 2] = 2415062538259.0 / 6382199904604.0
    A_ex[6, 3] = -3924368632305.0 / 6964820224454.0
    A_ex[6, 4] = -4331110370267.0 / 15021686902756.0
    A_ex[6, 5] = -3944303808049.0 / 11994238218192.0
    A_ex[7, 0] = 2193717860234.0 / 3570523412979.0
    A_ex[7, 1] = 2193717860234.0 / 3570523412979.0
    A_ex[7, 2] = 5952760925747.0 / 18750164281544.0
    A_ex[7, 3] = -4412967128996.0 / 6196664114337.0
    A_ex[7, 4] = 4151782504231.0 / 36106512998704.0
    A_ex[7, 5] = 572599549169.0 / 6265429158920.0
    A_ex[7, 6] = -457874356192.0 / 11306498036315.0
    C = [0.0, 4.0 / 9.0, 6456083330201.0 / 8509243623797.0,
         1632083962415.0 / 14158861528103.0,
         6365430648612.0 / 17842476412687.0, 18.0 / 25.0, 191.0 / 200.0, 1.0]
    return AdditiveRungeKutta(rhs_ex, rhs_im, solver, dt, A_ex, A_im, b, C,
                              **kw)


def ARK437L2SA1KennedyCarpenter(rhs_ex, rhs_im, solver, dt, **kw):
    """7-stage 4th-order ARK4(3)7L[2]SA₁ of Kennedy & Carpenter (2019):
    stiffly accurate ESDIRK with diagonal γ = 0.1235."""
    g = 1235.0 / 10000.0
    n = 7
    A_im = np.zeros((n, n))
    A_ex = np.zeros((n, n))
    for i in range(1, n):
        A_im[i, i] = g
    A_im[2, 1] = 624185399699.0 / 4186980696204.0
    A_im[3, 1] = 1258591069120.0 / 10082082980243.0
    A_im[3, 2] = -322722984531.0 / 8455138723562.0
    A_im[4, 1] = -436103496990.0 / 5971407786587.0
    A_im[4, 2] = -2689175662187.0 / 11046760208243.0
    A_im[4, 3] = 4431412449334.0 / 12995360898505.0
    A_im[5, 1] = -2207373168298.0 / 14430576638973.0
    A_im[5, 2] = 242511121179.0 / 3358618340039.0
    A_im[5, 3] = 3145666661981.0 / 7780404714551.0
    A_im[5, 4] = 5882073923981.0 / 14490790706663.0
    B = np.zeros(n)
    B[2] = 9164257142617.0 / 17756377923965.0
    B[3] = -10812980402763.0 / 74029279521829.0
    B[4] = 1335994250573.0 / 5691609445217.0
    B[5] = 2273837961795.0 / 8368240463276.0
    B[6] = 247.0 / 2000.0
    A_im[6, :6] = B[:6]                     # stiffly accurate last row
    for i in range(1, n):
        A_im[i, 0] = A_im[i, 1]
    C = np.zeros(n)
    C[1] = 247.0 / 1000.0
    C[2] = 4276536705230.0 / 10142255878289.0
    C[3] = 67.0 / 200.0
    C[4] = 3.0 / 40.0
    C[5] = 7.0 / 10.0
    C[6] = 1.0
    A_ex[1, 0] = C[1]
    A_ex[2, 0] = 247.0 / 4000.0
    A_ex[2, 1] = 2694949928731.0 / 7487940209513.0
    A_ex[3, 0] = 464650059369.0 / 8764239774964.0
    A_ex[3, 1] = 878889893998.0 / 2444806327765.0
    A_ex[3, 2] = -952945855348.0 / 12294611323341.0
    A_ex[4, 0] = 476636172619.0 / 8159180917465.0
    A_ex[4, 1] = -1271469283451.0 / 7793814740893.0
    A_ex[4, 2] = -859560642026.0 / 4356155882851.0
    A_ex[4, 3] = 1723805262919.0 / 4571918432560.0
    A_ex[5, 0] = 6338158500785.0 / 11769362343261.0
    A_ex[5, 1] = -4970555480458.0 / 10924838743837.0
    A_ex[5, 2] = 3326578051521.0 / 2647936831840.0
    A_ex[5, 3] = -880713585975.0 / 1841400956686.0
    A_ex[5, 4] = -1428733748635.0 / 8843423958496.0
    A_ex[6, 1] = 760814592956.0 / 3276306540349.0
    A_ex[6, 2] = -47223648122716.0 / 6934462133451.0
    A_ex[6, 3] = 71187472546993.0 / 9669769126921.0
    A_ex[6, 4] = -13330509492149.0 / 9695768672337.0
    A_ex[6, 5] = 11565764226357.0 / 8513123442827.0
    A_ex[6, 0] = A_ex[6, 1]
    return AdditiveRungeKutta(rhs_ex, rhs_im, solver, dt, A_ex, A_im, B, C,
                              **kw)


def DBM453VoglEtAl(rhs_ex, rhs_im, solver, dt, **kw):
    """5-stage 3rd-order ARK of Vogl et al. (2019), DBM4(5)3, tuned for
    HEVI atmosphere stepping; two of its weights B are negative."""
    g = 0.32591194130117247
    n = 5
    A_im = np.zeros((n, n))
    A_ex = np.zeros((n, n))
    for i in range(1, n):
        A_im[i, i] = g
    A_im[1, 0] = -0.22284985318525410
    A_im[2, 0] = -0.46801347074080545
    A_im[2, 1] = 0.86349284225716961
    A_im[3, 0] = -0.46509906651927421
    A_im[3, 1] = 0.81063103116959553
    A_im[3, 2] = 0.61036726756832357
    A_im[4, 0] = 0.87795339639076675
    A_im[4, 1] = -0.72692641526151547
    A_im[4, 2] = 0.75204137157372720
    A_im[4, 3] = -0.22898029400415088
    A_ex[1, 0] = 0.10306208811591838
    A_ex[2, 0] = -0.94124866143519894
    A_ex[2, 1] = 1.66263997425273560
    A_ex[3, 0] = -1.36709752014377650
    A_ex[3, 1] = 1.38158529110168730
    A_ex[3, 2] = 1.26732340256190650
    A_ex[4, 0] = -0.81287582068772448
    A_ex[4, 1] = 0.81223739060505738
    A_ex[4, 2] = 0.90644429603699305
    A_ex[4, 3] = 0.094194134045674111
    B = [0.87795339639076672, -0.72692641526151549, 0.7520413715737272,
         -0.22898029400415090, 0.32591194130117247]
    C = [0.0, 0.1030620881159184, 0.72139131281753662,
         1.28181117351981733, 1.0]
    return AdditiveRungeKutta(rhs_ex, rhs_im, solver, dt, A_ex, A_im, B, C,
                              **kw)
