"""Interface (numerical) fluxes on var-major face lanes (port of
``climatemachine_tpu/dg/numerical_fluxes.py`` ``RusanovNumericalFlux``
:34-50, and of the dry atmosphere's Riemann solvers in
``climatemachine_tpu/atmos/numerical_fluxes.py``: ``RoeNumericalFlux``
:25-172, its linear-model form ``_roe_linear`` :25-66, and
``HLLCNumericalFlux`` :174-241).

Face data is var-major: states ``[E, n, X]`` over X face nodes, unit
normals ``[E, 3, X]``; a balance law's ``flux_first_order`` gives
``[E, 3, n, X]`` (direction i, then variable) and its ``wavespeed``
``[E, X]``.  The result is the normal numerical flux ``[E, n, X]``.
Roe and HLLC take the dry AtmosModel (ρ, ρu, ρe) and the linear
acoustic(-gravity) models; the moist Roe waits for the generic moist
operator.
"""

from __future__ import annotations

import torch

from climatemachine_tpu_torch.physics import thermodynamics as td


def _normal_flux(bl, nrm, q, aux, t):
    """n · F(q) ``[E, n, X]`` of the balance law's first-order flux."""
    F = bl.flux_first_order(q, aux, t)
    return (F[:, 0] * nrm[:, 0, None] + F[:, 1] * nrm[:, 1, None]
            + F[:, 2] * nrm[:, 2, None])


def _is_linear(bl) -> bool:
    """A linear acoustic(-gravity) model (atmos/linear.py)."""
    return hasattr(bl, "linearized_pressure") and hasattr(bl, "atmos")


def _refuse_moist(bl, name: str):
    if bl.prog_spec.num != 5:
        raise NotImplementedError(
            f"next slice: the {name} flux on a moist model")


class RusanovNumericalFlux:
    """Local Lax-Friedrichs: the central flux ½(F⁻ + F⁺)·n minus
    ½·max(c⁻, c⁺)·(q⁺ − q⁻)."""

    def __call__(self, bl, nrm, qM, auxM, qP, auxP, t):
        Fs = bl.flux_first_order(qM, auxM, t) + bl.flux_first_order(qP, auxP,
                                                                     t)
        central = 0.5 * (Fs[:, 0] * nrm[:, 0, None] + Fs[:, 1] * nrm[:, 1, None]
                         + Fs[:, 2] * nrm[:, 2, None])
        c = bl.wavespeed(nrm, qM, auxM, t).maximum(
            bl.wavespeed(nrm, qP, auxP, t))
        return central - 0.5 * c[:, None] * (qP - qM)


def _roe_linear(bl, nrm, qM, auxM, qP, auxP, t):
    """Roe flux of a linear acoustic(-gravity) model: the central flux
    plus the reference state's acoustic dissipation."""
    _refuse_moist(bl, "Roe")
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
    in the offset convention e_int = cv_d (T − T_0)); on a linear model
    the central flux plus the reference state's acoustic dissipation."""

    def __call__(self, bl, nrm, qM, auxM, qP, auxP, t):
        if _is_linear(bl):
            return _roe_linear(bl, nrm, qM, auxM, qP, auxP, t)
        _refuse_moist(bl, "Roe")
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
        return out


class HLLCNumericalFlux:
    """HLLC with Einfeldt wavespeed estimates; a linear model has no
    intermediate wave, so there it is the Rusanov flux."""

    def __call__(self, bl, nrm, qM, auxM, qP, auxP, t):
        if _is_linear(bl):
            return RusanovNumericalFlux()(bl, nrm, qM, auxM, qP, auxP, t)
        _refuse_moist(bl, "HLLC")
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
                              (fac * Estar)[:, None]], dim=1)

        FMs = FM + SL[:, None] * (star_state(qM, rhoM, uM, unM, pM, SL) - qM)
        FPs = FP + SR[:, None] * (star_state(qP, rhoP, uP, unP, pP, SR) - qP)
        SL, SR, Ss = SL[:, None], SR[:, None], Ss[:, None]
        return torch.where(SL >= 0, FM,
                           torch.where(Ss >= 0, FMs,
                                       torch.where(SR >= 0, FPs, FP)))
