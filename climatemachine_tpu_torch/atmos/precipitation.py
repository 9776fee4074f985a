"""Precipitation models and microphysics sources (port of
``climatemachine_tpu/atmos/precipitation.py``: ``NoPrecipitation`` :21,
``RainModel`` :27 with its sedimentation flux :41-51,
``RemovePrecipitation`` :53, ``WarmRain1M`` :78, ``RainSnowModel`` :116
and ``RainSnow1M`` :151).

A precipitation model names its prognostic lanes (``precipitation.
rhoq_rai`` and, with snow, ``precipitation.rhoq_sno``, after the
moisture lanes) and sets their first-order flux: advection by u and
sedimentation at the terminal velocity along −k̂.  The sources read the
moisture model's phase partition and T from the :class:`VMContext` of
the generic DG operator, and give nothing on a dry model; the var-major
RHS does not take them (``on_var_major_rhs``), as the JAX package's
does not.  State, aux and the context's fields are var-major ``[E, n,
L]``; fluxes ``[E, 3, n, L]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from climatemachine_tpu_torch.atmos.sources import Source, VMContext
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.utils.variables import VarSpec


def _power_law(v0: float, q, exponent: float):
    """v0 · max(q, 0)^exponent."""
    return v0 * torch.clamp_min(q, 0.0) ** exponent


def _sedimenting(model, q, aux, F, u, name: str, vt_of):
    """F[name] = ρq (u − v_t(q) k̂) (in place), k̂ = ∇Φ/g."""
    sp = model.prog_spec
    rq = sp.get(q, name)
    k = model.aux_spec.get(aux, "orientation.grad_Phi") \
        / model.param_set.grav
    vt = vt_of(rq / sp.get(q, "rho"))
    F[:, :, sp.index(name).start] = rq[:, None] * (u - vt[:, None] * k)
    return F


class NoPrecipitation:
    def vars_prognostic(self) -> VarSpec:
        return VarSpec()


@dataclass
class RainModel(NoPrecipitation):
    """Warm rain, one moment: prognostic ρq_rai, advected and falling at
    v_t = v0 · q_rai^q_exp."""
    v0: float = 14.0
    q_exp: float = 0.125

    def vars_prognostic(self) -> VarSpec:
        return VarSpec(rhoq_rai=1)

    def terminal_velocity(self, q_rai):
        return _power_law(self.v0, q_rai, self.q_exp)

    def flux_first_order(self, model, q, aux, F, u):
        """Advection and sedimentation of ρq_rai along −k̂ (in place on
        F ``[E, 3, n, L]``; u ``[E, 3, L]``)."""
        return _sedimenting(model, q, aux, F, u, "precipitation.rhoq_rai",
                            self.terminal_velocity)


@dataclass
class RainSnowModel(NoPrecipitation):
    """Rain and snow, one moment each: prognostic ρq_rai and ρq_sno, each
    advected and falling at its own power-law terminal velocity."""
    v0_rai: float = 14.0
    q_exp_rai: float = 0.125
    v0_sno: float = 2.5
    q_exp_sno: float = 0.0625

    def vars_prognostic(self) -> VarSpec:
        return VarSpec(rhoq_rai=1, rhoq_sno=1)

    def terminal_velocity_rain(self, q_rai):
        return _power_law(self.v0_rai, q_rai, self.q_exp_rai)

    def terminal_velocity_snow(self, q_sno):
        return _power_law(self.v0_sno, q_sno, self.q_exp_sno)

    def flux_first_order(self, model, q, aux, F, u):
        F = _sedimenting(model, q, aux, F, u, "precipitation.rhoq_rai",
                         self.terminal_velocity_rain)
        return _sedimenting(model, q, aux, F, u, "precipitation.rhoq_sno",
                            self.terminal_velocity_snow)


class _Microphysics(Source):
    """A source of the generic DG operator only."""

    on_var_major_rhs = False


def _energies(ps, T):
    """(I_l, I_i): the specific internal energies of liquid and ice at T
    (the e_int offset convention of physics/thermodynamics.py)."""
    return (ps.cv_l * (T - ps.T_0),
            ps.cv_i * (T - ps.T_0) - ps.e_int_i0)


@dataclass
class RemovePrecipitation(_Microphysics):
    """Zero moment: condensate above ``qc_0`` leaves on the timescale
    ``tau``, with the matching sink of ρ and of energy."""
    tau: float = 1000.0
    qc_0: float = 5e-4

    def contributions_vm(self, model, ctx: VMContext, t):
        pp = ctx.pp
        if pp is None:
            return {}
        ps, T, rho = model.param_set, ctx.T, ctx.rho
        S_qt = -rho * torch.clamp_min(pp.liq + pp.ice - self.qc_0, 0.0) \
            / self.tau
        lam = td.liquid_fraction(ps, T)
        I_l, I_i = _energies(ps, T)
        Phi = ctx.aux("orientation.Phi")
        S_e = S_qt * (lam * I_l + (1 - lam) * I_i + Phi)
        return {"moisture.rhoq_tot": S_qt, "rhoe": S_e, "rho": S_qt}


@dataclass
class WarmRain1M(_Microphysics):
    """Warm-rain processes, Kessler type: autoconversion and accretion of
    cloud liquid into rain, evaporation of rain in subsaturated air; the
    rain's gain leaves ρq_tot, ρ and ρe."""
    tau_acnv: float = 1000.0
    q_liq_threshold: float = 5e-4
    accr_coeff: float = 2.2
    evap_coeff: float = 1e-3

    def contributions_vm(self, model, ctx: VMContext, t):
        pp = ctx.pp
        if pp is None:
            return {}
        ps, T, rho = model.param_set, ctx.T, ctx.rho
        sp = model.prog_spec
        q_rai = torch.clamp_min(sp.get(ctx.q, "precipitation.rhoq_rai")
                                / rho, 0.0)
        acnv = torch.clamp_min(pp.liq - self.q_liq_threshold, 0.0) \
            / self.tau_acnv
        accr = self.accr_coeff * pp.liq * q_rai ** 0.875
        q_sat = td.q_vap_saturation(ps, T, rho)
        subsat = torch.clamp_min(1.0 - pp.vap / q_sat, 0.0)
        evap = self.evap_coeff * subsat * q_rai ** 0.65
        dq_rain = acnv + accr - evap
        I_l, _ = _energies(ps, T)
        Phi = ctx.aux("orientation.Phi")
        return {"precipitation.rhoq_rai": rho * dq_rain,
                "moisture.rhoq_tot": -rho * dq_rain,
                "rho": -rho * dq_rain,
                "rhoe": -rho * dq_rain * (I_l + Phi)}


@dataclass
class RainSnow1M(_Microphysics):
    """Cold-rain processes, one moment: autoconversion into rain and
    snow, accretion of cloud liquid and ice by rain and snow (freezing
    or melting by temperature), rain freezing on cloud ice, rain-snow
    accretion, rain evaporation, snow sublimation and deposition, snow
    melt; with the energy of each transfer."""
    tau_acnv_rai: float = 1000.0
    q_liq_threshold: float = 5e-4
    tau_acnv_sno: float = 1000.0
    q_ice_threshold: float = 1e-4
    accr_coeff: float = 2.2
    evap_coeff: float = 1e-3
    subl_coeff: float = 5e-4
    melt_coeff: float = 5e-5

    def contributions_vm(self, model, ctx: VMContext, t):
        pp = ctx.pp
        if pp is None:
            return {}
        ps, T, rho = model.param_set, ctx.T, ctx.rho
        sp = model.prog_spec
        q_rai = torch.clamp_min(sp.get(ctx.q, "precipitation.rhoq_rai")
                                / rho, 0.0)
        q_sno = torch.clamp_min(sp.get(ctx.q, "precipitation.rhoq_sno")
                                / rho, 0.0)
        I_l, I_i = _energies(ps, T)
        L_f = td.latent_heat_fusion(ps, T)
        Phi = ctx.aux("orientation.Phi")
        freezing = T < ps.T_freeze
        k = self.accr_coeff

        # autoconversion liq → rain, ice → snow
        acnv_r = torch.clamp_min(pp.liq - self.q_liq_threshold, 0.0) \
            / self.tau_acnv_rai
        acnv_s = torch.clamp_min(pp.ice - self.q_ice_threshold, 0.0) \
            / self.tau_acnv_sno
        S_qr = acnv_r.clone()
        S_qs = acnv_s.clone()
        S_e = -acnv_r * (I_l + Phi) - acnv_s * (I_i + Phi)

        # accretion: cloud liquid by rain, cloud ice by snow
        accr_lr = k * pp.liq * q_rai ** 0.875
        accr_is = k * pp.ice * q_sno ** 0.875
        S_qr += accr_lr
        S_e -= accr_lr * (I_l + Phi)
        S_qs += accr_is
        S_e -= accr_is * (I_i + Phi)

        # cloud liquid by snow: freezes below T_freeze, else melts to rain
        accr_ls = k * pp.liq * q_sno ** 0.875
        alpha = ps.cv_l / L_f * (T - ps.T_freeze)
        S_qs += torch.where(freezing, accr_ls, -accr_ls * alpha)
        S_qr += torch.where(freezing, 0.0, accr_ls * (1 + alpha))
        S_e -= torch.where(freezing, accr_ls * (I_i + Phi),
                           accr_ls * ((1 + alpha) * I_l - alpha * I_i + Phi))

        # cloud ice by rain: the rain freezes into snow
        accr_ir = k * pp.ice * q_rai ** 0.875
        sink_r = k * q_rai * pp.ice ** 0.875
        S_qs += accr_ir + sink_r
        S_qr -= sink_r
        S_e -= accr_ir * (I_i + Phi) - sink_r * L_f

        # rain-snow accretion: rain → snow below freezing, snow → rain above
        accr_rs = k * q_rai * q_sno
        S_qs += torch.where(freezing, accr_rs, -accr_rs)
        S_qr -= torch.where(freezing, accr_rs, -accr_rs)
        S_e += torch.where(freezing, accr_rs * L_f, -accr_rs * L_f)

        # rain evaporation, snow sublimation (deposition) in subsaturated
        # (supersaturated) air
        q_sat = td.q_vap_saturation(ps, T, rho)
        subsat = 1.0 - pp.vap / q_sat
        evap = -self.evap_coeff * torch.clamp_min(subsat, 0.0) \
            * q_rai ** 0.65
        S_qr += evap
        S_e -= evap * (I_l + Phi)
        subl = -self.subl_coeff * subsat * q_sno ** 0.65
        S_qs += subl
        S_e -= subl * (I_i + Phi)

        # snow melt above freezing
        melt = torch.where(freezing, 0.0, self.melt_coeff * q_sno ** 0.65
                           * (T - ps.T_freeze))
        S_qs -= melt
        S_qr += melt
        S_e -= melt * L_f

        S_qt = -S_qr - S_qs
        return {"precipitation.rhoq_rai": rho * S_qr,
                "precipitation.rhoq_sno": rho * S_qs,
                "moisture.rhoq_tot": rho * S_qt,
                "rho": rho * S_qt,
                "rhoe": rho * S_e}
