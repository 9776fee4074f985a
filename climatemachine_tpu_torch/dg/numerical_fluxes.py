"""Interface (numerical) fluxes on var-major face lanes (port of
``climatemachine_tpu/dg/numerical_fluxes.py``
``CentralNumericalFluxFirstOrder`` :25, ``RusanovNumericalFlux`` :34-50
with the balance law's ``numerical_flux_penalty`` hook :47-49,
``CentralNumericalFluxGradient`` :53-64 and
``CentralNumericalFluxSecondOrder`` :73-81, and of the atmosphere's Riemann solvers in
``climatemachine_tpu/atmos/numerical_fluxes.py``: ``RoeNumericalFlux``
:66-172 with its passive-scalar upwinding :151-170, its linear-model
form ``_roe_linear`` :25-63, ``HLLCNumericalFlux`` :174-241,
``LMARSNumericalFlux`` :242-305 and ``RoeNumericalFluxMoist`` :307).

Face data is var-major: states ``[E, n, X]`` over X face nodes, unit
normals ``[E, d, X]`` (d = 3, or 2 on a 2-D grid); a balance law's
``flux_first_order`` gives ``[E, d, n, X]`` (direction i, then
variable) and its ``wavespeed`` ``[E, X]``.  The result is the normal numerical flux ``[E, n, X]``.
The lanes past ρe (ρq_tot, the precipitation's, the tracers') are
advected scalars: Roe upwinds them on the contact wave, HLLC carries them
through its star states, LMARS upwinds them by its interface velocity.
On a linear acoustic(-gravity) model Roe needs a dry atmosphere, as the
JAX package's does, and HLLC is the Rusanov flux.
"""

from __future__ import annotations

import math

import torch

from climatemachine_tpu_torch.atmos.moisture import DryModel
from climatemachine_tpu_torch.physics import thermodynamics as td


def _dot_n(F, nrm):
    """Σ_i F_i n_i ``[E, n, X]`` of a flux ``[E, d, n, X]``, summed in
    direction order."""
    acc = F[:, 0] * nrm[:, 0, None]
    for i in range(1, nrm.shape[1]):
        acc = acc + F[:, i] * nrm[:, i, None]
    return acc


def _normal_flux(bl, nrm, q, aux, t):
    """n · F(q) ``[E, n, X]`` of the balance law's first-order flux."""
    return _dot_n(bl.flux_first_order(q, aux, t), nrm)


def _is_linear(bl) -> bool:
    """A linear acoustic(-gravity) model (atmos/linear.py)."""
    return hasattr(bl, "linearized_pressure") and hasattr(bl, "atmos")


def _central(bl, nrm, qM, auxM, qP, auxP, t):
    """½(F(q⁻) + F(q⁺))·n ``[E, n, X]``."""
    Fs = bl.flux_first_order(qM, auxM, t) + bl.flux_first_order(qP, auxP, t)
    return 0.5 * _dot_n(Fs, nrm)


class CentralNumericalFluxFirstOrder:
    """The central flux ½(F⁻ + F⁺)·n."""

    def __call__(self, bl, nrm, qM, auxM, qP, auxP, t):
        return _central(bl, nrm, qM, auxM, qP, auxP, t)


class RusanovNumericalFlux:
    """Local Lax-Friedrichs: the central flux ½(F⁻ + F⁺)·n minus
    ½·max(c⁻, c⁺)·Δq, Δq = q⁺ − q⁻ as the balance law's
    ``numerical_flux_penalty(nrm, qM, auxM, qP, auxP, Δq)`` adjusts it
    where it has one (the ocean's Δη = 0)."""

    def __call__(self, bl, nrm, qM, auxM, qP, auxP, t):
        central = _central(bl, nrm, qM, auxM, qP, auxP, t)
        c = bl.wavespeed(nrm, qM, auxM, t).maximum(
            bl.wavespeed(nrm, qP, auxP, t))
        dq = qP - qM
        if hasattr(bl, "numerical_flux_penalty"):
            dq = bl.numerical_flux_penalty(nrm, qM, auxM, qP, auxP, dq)
        return central - 0.5 * c[:, None] * dq


class CentralNumericalFluxGradient:
    """g* = ½(g⁻ + g⁺), returned as the jump correction n ⊗ (g* − g⁻)
    ``[E, d, ng, X]`` (direction i, then variable) that the strong-form
    gradient lifts, of gradient arguments ``[E, ng, X]``."""

    def __call__(self, bl, nrm, gM, gP):
        return nrm[:, :, None, :] * (0.5 * (gP + gM) - gM)[:, None]


class CentralNumericalFluxSecondOrder:
    """F₂* = ½(F₂(q⁻, gf⁻, hyper⁻) + F₂(q⁺, gf⁺, hyper⁺))·n ``[E, n, X]``,
    from the balance law's ``flux_second_order`` on each side."""

    def __call__(self, bl, nrm, qM, gfM, auxM, qP, gfP, auxP, t,
                 hyperM=None, hyperP=None):
        Fs = (bl.flux_second_order(qM, gfM, hyperM, auxM, t)
              + bl.flux_second_order(qP, gfP, hyperP, auxP, t))
        return 0.5 * _dot_n(Fs, nrm)


def _roe_linear(bl, nrm, qM, auxM, qP, auxP, t):
    """Roe flux of a linear acoustic(-gravity) model: the central flux
    plus the reference state's acoustic dissipation.  The advected
    scalars of a moist atmosphere would get the central flux alone,
    unstable for their jumps: refused, as in the JAX package."""
    if not isinstance(bl.atmos.physics.moisture, DryModel):
        raise NotImplementedError(
            "RoeNumericalFlux on AtmosLinearModel requires DryModel "
            "moisture")
    ps, get = bl.param_set, bl.aux_spec.get
    out = 0.5 * (_normal_flux(bl, nrm, qM, auxM, t)
                 + _normal_flux(bl, nrm, qP, auxP, t))

    def refs(aux):
        h = (get(aux, "ref_state.rhoe") + get(aux, "ref_state.p")) \
            / get(aux, "ref_state.rho")
        return h, td.soundspeed_air(ps, get(aux, "ref_state.T"))

    hM, cM = refs(auxM)
    hP, cP = refs(auxP)
    h = 0.5 * (hM + hP)
    c = 0.5 * (cM + cP)
    dpL = bl.linearized_pressure(qP, auxP) - bl.linearized_pressure(qM, auxM)
    drhou_n = torch.sum((qP[:, 1:4] - qM[:, 1:4]) * nrm, dim=1)
    out[:, 0] -= dpL / (2.0 * c)
    out[:, 1:4] -= 0.5 * (c * drhou_n)[:, None] * nrm
    out[:, 4] -= h * dpL / (2.0 * c)
    return out


def _sides(bl, q, aux):
    """ρ, u ``[E, 3, X]``, T and p of one side."""
    rho = q[:, 0]
    T, p = bl.thermo(q, aux)
    return rho, q[:, 1:4] / rho[:, None], T, p


class RoeNumericalFlux:
    """Roe flux with the Roe-averaged wave decomposition (the Roe average
    of the two sides' squared sound speeds, and the contact wave's energy
    in the offset convention e_int = cv_d (T − T_0)), each advected
    scalar χ upwinded on the contact wave about its Roe average χ̃
    (dissipation χ̃ d_ρ + |ũ·n| (Δρχ − χ̃ Δρ)); on a linear model the
    central flux plus the reference state's acoustic dissipation."""

    def __call__(self, bl, nrm, qM, auxM, qP, auxP, t):
        if _is_linear(bl):
            return _roe_linear(bl, nrm, qM, auxM, qP, auxP, t)
        ps = bl.param_set
        rhoM, uM, TM, pM = _sides(bl, qM, auxM)
        rhoP, uP, TP, pP = _sides(bl, qP, auxP)
        hM = (qM[:, 4] + pM) / rhoM
        hP = (qP[:, 4] + pP) / rhoP
        cM = td.soundspeed_air(ps, TM)
        cP = td.soundspeed_air(ps, TP)
        Phi = bl.aux_spec.get(auxM, "orientation.Phi")

        sM, sP = torch.sqrt(rhoM), torch.sqrt(rhoP)
        w = sM / (sM + sP)
        uh = w[:, None] * uM + (1 - w)[:, None] * uP
        hh = w * hM + (1 - w) * hP
        rhoh = sM * sP
        ke = 0.5 * torch.sum(uh * uh, dim=1)
        c2 = w * cM ** 2 + (1 - w) * cP ** 2
        ch = torch.sqrt(c2)
        un = torch.sum(uh * nrm, dim=1)

        drho = rhoP - rhoM
        dp = pP - pM
        du = uP - uM
        dun = torch.sum(du * nrm, dim=1)
        dut = du - dun[:, None] * nrm

        l1, l2, l3 = torch.abs(un - ch), torch.abs(un), torch.abs(un + ch)
        w1 = (dp - rhoh * ch * dun) / (2 * c2)
        w3 = (dp + rhoh * ch * dun) / (2 * c2)
        w2 = drho - dp / c2

        d_rho = l1 * w1 + l2 * w2 + l3 * w3
        d_rhou = ((l1 * w1)[:, None] * (uh - ch[:, None] * nrm)
                  + l2[:, None] * (w2[:, None] * uh + rhoh[:, None] * dut)
                  + (l3 * w3)[:, None] * (uh + ch[:, None] * nrm))
        d_rhoe = (l1 * w1 * (hh - ch * un)
                  + l2 * (w2 * (ke + Phi - ps.cv_d * ps.T_0)
                          + rhoh * torch.sum(uh * dut, dim=1))
                  + l3 * w3 * (hh + ch * un))

        out = 0.5 * (_normal_flux(bl, nrm, qM, auxM, t)
                     + _normal_flux(bl, nrm, qP, auxP, t))
        out[:, 0] -= 0.5 * d_rho
        out[:, 1:4] -= 0.5 * d_rhou
        out[:, 4] -= 0.5 * d_rhoe
        for v in range(5, qM.shape[1]):
            phiM, phiP = qM[:, v] / rhoM, qP[:, v] / rhoP
            phih = w * phiM + (1 - w) * phiP
            out[:, v] -= 0.5 * (l2 * (phiP * rhoP - phiM * rhoM - phih * drho)
                                + phih * d_rho)
        return out


class HLLCNumericalFlux:
    """HLLC with Einfeldt wavespeed estimates, the advected scalars
    carried by the star states at their specific values; a linear model
    has no intermediate wave, so there it is the Rusanov flux."""

    def __call__(self, bl, nrm, qM, auxM, qP, auxP, t):
        if _is_linear(bl):
            return RusanovNumericalFlux()(bl, nrm, qM, auxM, qP, auxP, t)
        ps = bl.param_set
        rhoM, uM, TM, pM = _sides(bl, qM, auxM)
        rhoP, uP, TP, pP = _sides(bl, qP, auxP)
        cM = td.soundspeed_air(ps, TM)
        cP = td.soundspeed_air(ps, TP)
        unM = torch.sum(uM * nrm, dim=1)
        unP = torch.sum(uP * nrm, dim=1)

        SL = torch.minimum(unM - cM, unP - cP)
        SR = torch.maximum(unM + cM, unP + cP)
        num = (pP - pM + rhoM * unM * (SL - unM)
               - rhoP * unP * (SR - unP))
        den = rhoM * (SL - unM) - rhoP * (SR - unP)
        Ss = num / torch.where(torch.abs(den) < 1e-12, 1e-12, den)

        FM = _normal_flux(bl, nrm, qM, auxM, t)
        FP = _normal_flux(bl, nrm, qP, auxP, t)

        def star_state(q, rho, u, un, p, S):
            """The star region's conserved state."""
            fac = rho * (S - un) / (S - Ss)
            ustar = u + (Ss - un)[:, None] * nrm
            Estar = q[:, 4] / rho + (Ss - un) * (Ss + p / (rho * (S - un)))
            return torch.cat([fac[:, None], fac[:, None] * ustar,
                              (fac * Estar)[:, None],
                              fac[:, None] * (q[:, 5:] / rho[:, None])],
                             dim=1)

        FMs = FM + SL[:, None] * (star_state(qM, rhoM, uM, unM, pM, SL) - qM)
        FPs = FP + SR[:, None] * (star_state(qP, rhoP, uP, unP, pP, SR) - qP)
        SL, SR, Ss = SL[:, None], SR[:, None], Ss[:, None]
        return torch.where(SL >= 0, FM,
                           torch.where(Ss >= 0, FMs,
                                       torch.where(SR >= 0, FPs, FP)))


class LMARSNumericalFlux:
    """Low Mach number approximate Riemann solver (Chen et al. 2013, eqs.
    46-50): an acoustic solve gives the interface velocity u½ and
    pressure p½ (with the reference pressure taken out where the model's
    volume flux takes it out), about the two sides' mean sound speed;
    ρ, ρu, ρh and every advected scalar are upwinded by the sign of u½."""

    def __init__(self, beta: float = 1.0):
        self.beta = float(beta)

    def __call__(self, bl, nrm, qM, auxM, qP, auxP, t):
        ps = bl.param_set
        rhoM, rhoP = qM[:, 0], qP[:, 0]
        TM, pM, uM, ppM = bl.thermo_full(qM, auxM)
        TP, pP, uP, ppP = bl.thermo_full(qP, auxP)
        if bl.ref_state.subtract_off:
            get = bl.aux_spec.get
            pM = pM - get(auxM, "ref_state.p")
            pP = pP - get(auxP, "ref_state.p")
        c_h = 0.5 * (td.soundspeed_air(ps, TM, ppM)
                     + td.soundspeed_air(ps, TP, ppP))
        unM = torch.sum(uM * nrm, dim=1)
        unP = torch.sum(uP * nrm, dim=1)
        hM = (qM[:, 4] + pM) / rhoM
        hP = (qP[:, 4] + pP) / rhoP

        b = self.beta
        u_half = 0.5 * (unP + unM) - b / (rhoM + rhoP) / c_h * (pP - pM)
        p_half = 0.5 * (pP + pM) - b * (rhoM + rhoP) * c_h / 4 * (unP - unM)
        up = (u_half > 0.0)[:, None]
        qb = torch.where(up, qM, qP)
        rhoh_b = torch.where(up[:, 0], rhoM * hM, rhoP * hP)
        return torch.cat([(qb[:, 0] * u_half)[:, None],
                          qb[:, 1:4] * u_half[:, None]
                          + p_half[:, None] * nrm,
                          (rhoh_b * u_half)[:, None],
                          qb[:, 5:] * u_half[:, None]], dim=1)


class RoeNumericalFluxMoist:
    """Roe flux of an EquilMoist atmosphere: the six-wave decomposition of
    (ρ, ρu, ρe, ρq_tot) about the Roe-averaged moist state (its
    temperature by the saturation adjustment at the averaged e_int, ρ and
    q_tot), optionally with the low-Mach scaling of the acoustic
    eigenvalues (``LM``).  The dissipation M Λ M⁻¹ Δq solves one 6 × 6
    system per face node; the other lanes (precipitation, tracers) get
    the central flux."""

    def __init__(self, LM: bool = False):
        self.LM = bool(LM)

    def __call__(self, bl, nrm, qM, auxM, qP, auxP, t):
        ps = bl.param_set
        sp = bl.prog_spec
        gamma_d = ps.cp_d / ps.cv_d
        i_q = sp.index("moisture.rhoq_tot").start

        rhoM, rhoP = qM[:, 0], qP[:, 0]
        TM, pM, uM, ppM = bl.thermo_full(qM, auxM)
        TP, pP, uP, ppP = bl.thermo_full(qP, auxP)
        hM = (qM[:, 4] + pM) / rhoM
        hP = (qP[:, 4] + pP) / rhoP
        qtM, qtP = qM[:, i_q] / rhoM, qP[:, i_q] / rhoP
        Phi = bl.aux_spec.get(auxM, "orientation.Phi")

        sM, sP = torch.sqrt(rhoM), torch.sqrt(rhoP)
        w = sM / (sM + sP)
        roe = lambda a, b: (w[:, None] * a + (1 - w)[:, None] * b
                            if a.dim() == w.dim() + 1
                            else w * a + (1 - w) * b)
        uh, hh, qt = roe(uM, uP), roe(hM, hP), roe(qtM, qtP)
        rho = sM * sP
        e_int = roe(td.internal_energy(ps, TM, ppM),
                    td.internal_energy(ps, TP, ppP))
        Troe = td.saturation_adjustment(ps, e_int, rho, qt)
        cv_m = td.cv_m(ps, td.phase_partition_equil(ps, Troe, rho, qt))

        ke = 0.5 * torch.sum(uh * uh, dim=1)
        ch = torch.sqrt(torch.clamp_min((gamma_d - 1.0) * (hh - ke), 1e-10))
        un = torch.sum(uh * nrm, dim=1)
        c_lm = ch
        if self.LM:
            Mach = 0.5 * (torch.linalg.vector_norm(uM, dim=1)
                          / td.soundspeed_air(ps, TM, ppM)
                          + torch.linalg.vector_norm(uP, dim=1)
                          / td.soundspeed_air(ps, TP, ppP))
            c_lm = ch * torch.clamp_max(
                Mach * torch.sqrt(4.0 + (1.0 - Mach ** 2) ** 2)
                / (1.0 + Mach ** 2), 1.0)

        # a tangent basis from a fixed unit vector
        om, de = math.pi / 3, math.pi / 5
        rv = torch.tensor([math.sin(om) * math.cos(de),
                           math.cos(om) * math.cos(de), math.sin(de)],
                          dtype=qM.dtype, device=qM.device)
        tau1 = torch.linalg.cross(rv[None, :, None].expand_as(nrm), nrm,
                                  dim=1)
        tau2 = torch.linalg.cross(tau1, nrm, dim=1)
        ucm = uh - ch[:, None] * nrm
        ucp = uh + ch[:, None] * nrm
        one, zero = torch.ones_like(un), torch.zeros_like(un)
        # the right eigenvectors as columns, rows (ρ, ρu, ρe, ρq_tot)
        cols = [
            [one, *ucm.unbind(1), hh - ch * un, qt],
            [zero, *tau1.unbind(1), torch.sum(tau1 * uh, dim=1), zero],
            [zero, *tau2.unbind(1), torch.sum(tau2 * uh, dim=1), zero],
            [one, *uh.unbind(1), 2 * ke + Phi - ps.T_0 * cv_m, zero],
            [one, *ucp.unbind(1), hh + ch * un, qt],
            [zero, zero, zero, zero, ps.e_int_v0 * one, one]]
        Mmat = torch.stack([torch.stack(c, dim=-1) for c in cols], dim=-1)
        lam = torch.stack([torch.abs(un - c_lm), torch.abs(un),
                           torch.abs(un), torch.abs(un),
                           torch.abs(un + c_lm), torch.abs(un)], dim=-1)
        lanes = [0, 1, 2, 3, 4, i_q]
        dstate = (qP[:, lanes] - qM[:, lanes]).transpose(1, 2)
        wamp = torch.linalg.solve(Mmat, dstate[..., None])[..., 0]
        diss = torch.matmul(Mmat, (lam * wamp)[..., None])[..., 0]

        out = 0.5 * (_normal_flux(bl, nrm, qM, auxM, t)
                     + _normal_flux(bl, nrm, qP, auxP, t))
        out[:, lanes] -= 0.5 * diss.transpose(1, 2)
        return out
