"""Large-scale (GCM-driven) forcing of LES configurations (port of
``climatemachine_tpu/atmos/lsforcing.py``: ``NoLSForcing`` :28,
``HadGEMVertical`` :51, ``LargeScaleProcess`` :108,
``LargeScaleSubsidence`` :135 and ``LinearSponge`` :159).

``HadGEMVertical(profile)`` fills the aux lanes ``lsforcing.{ta, hus,
ua, va, temp_tendency, qt_tendency, w_s}`` once, at aux init, from
``profile(z)`` (z ``[E, Np]`` → a dict of ``[E, Np]`` tensors: air
temperature, specific humidity, the GCM wind, the summed temperature
and moisture tendencies and the subsidence velocity, positive up), and
puts ta and hus on the gradient lanes, whose vertical derivatives k̂·∇
it keeps as ``lsforcing.dz_ta`` and ``lsforcing.dz_hus``.  The sources
read them: GCM tendencies on ρe (ρ c_vm (Σ_T + w_s ∂T/∂z) + ρ e_int,v0
q̇), ρ and ρq_tot (ρ q̇, q̇ = Σ_q + w_s ∂q/∂z), subsidence −ρ w_s k̂·∇h_tot
(and −ρ w_s k̂·∇q_tot on ρ and ρq_tot), and a sponge toward (ua, va).
Without a gradient flux the first two add nothing.  Var-major: scalars
``[E, L]``, vectors ``[E, 3, L]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from climatemachine_tpu_torch.atmos.sources import Source, sponge_beta
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.utils.variables import VarSpec

#: HadGEMVertical's aux lanes, in order
PROFILE_FIELDS = ("ta", "hus", "ua", "va", "temp_tendency", "qt_tendency",
                  "w_s")


class NoLSForcing:
    """No large-scale forcing."""

    def vars_aux(self) -> VarSpec:
        return VarSpec()

    def vars_gradient(self) -> VarSpec:
        return VarSpec()

    def vars_gradient_flux(self) -> VarSpec:
        return VarSpec()

    def init_aux(self, model, z, aux):
        return aux

    def gradient_argument(self, model, q, aux, t, out):
        return out

    def gradient_flux(self, model, grad_g, q, aux, t, out):
        return out


@dataclass(frozen=True)
class HadGEMVertical(NoLSForcing):
    """The GCM profiles in aux and the vertical gradients of ta and hus
    (module docstring)."""
    profile: Callable

    def vars_aux(self) -> VarSpec:
        return VarSpec(**{name: 1 for name in PROFILE_FIELDS})

    def vars_gradient(self) -> VarSpec:
        return VarSpec(ta=1, hus=1)

    def vars_gradient_flux(self) -> VarSpec:
        return VarSpec(dz_ta=1, dz_hus=1)

    def init_aux(self, model, z, aux):
        fields = self.profile(z)
        out = aux.clone()
        for name in PROFILE_FIELDS:
            out[:, model.aux_spec.index(f"lsforcing.{name}").start] = \
                fields[name]
        return out

    def gradient_argument(self, model, q, aux, t, out):
        gs, ap = model.grad_spec, model.aux_spec
        out = out.clone()
        for name in ("ta", "hus"):
            out[:, gs.index(f"lsforcing.{name}").start] = ap.get(
                aux, f"lsforcing.{name}")
        return out

    def gradient_flux(self, model, grad_g, q, aux, t, out):
        k = model.vertical_unit(aux)
        gs, fs = model.grad_spec, model.gf_spec
        out = out.clone()
        for name in ("ta", "hus"):
            out[:, fs.index(f"lsforcing.dz_{name}").start] = torch.sum(
                grad_g[:, :, gs.index(f"lsforcing.{name}").start] * k, dim=1)
        return out


class LargeScaleProcess(Source):
    """The GCM's temperature and moisture tendencies on ρe, ρ and
    ρq_tot (a moist model's)."""
    on_var_major_rhs = False

    def contributions_vm(self, model, ctx, t):
        if ctx.gf is None:
            return {}
        ps, fs = model.param_set, model.gf_spec
        rho, w_s = ctx.rho, ctx.aux("lsforcing.w_s")
        T_tendency = (ctx.aux("lsforcing.temp_tendency")
                      + fs.get(ctx.gf, "lsforcing.dz_ta") * w_s)
        qt_tend = (ctx.aux("lsforcing.qt_tendency")
                   + fs.get(ctx.gf, "lsforcing.dz_hus") * w_s)
        return {"rhoe": (td.cv_m(ps, ctx.pp) * rho * T_tendency
                         + ps.e_int_v0 * rho * qt_tend),
                "rho": rho * qt_tend, "moisture.rhoq_tot": rho * qt_tend}


class LargeScaleSubsidence(Source):
    """−ρ w_s k̂·∇h_tot on ρe and, with moisture, −ρ w_s k̂·∇q_tot on ρ
    and ρq_tot, w_s from aux."""
    on_var_major_rhs = False

    def contributions_vm(self, model, ctx, t):
        if ctx.gf is None:
            return {}
        fs = model.gf_spec
        rho = ctx.rho
        k = ctx.grad_Phi / model.param_set.grav
        w_s = ctx.aux("lsforcing.w_s")
        out = {"rhoe": -rho * w_s * torch.sum(fs.get(ctx.gf, "d_h_tot") * k,
                                              dim=1)}
        try:
            d_q = fs.get(ctx.gf, "moisture.d_q_tot")
        except KeyError:
            return out
        out["rho"] = out["moisture.rhoq_tot"] = -rho * w_s * torch.sum(
            d_q * k, dim=1)
        return out


@dataclass(frozen=True)
class LinearSponge(Source):
    """−β (ρu − ρ u_gcm) above z_sponge (β of
    :func:`~climatemachine_tpu_torch.atmos.sources.sponge_beta`), u_gcm
    = (ua, va, 0) from aux."""
    z_max: float
    z_sponge: float
    alpha_max: float
    gamma: float = 2.0
    on_var_major_rhs = False

    def contributions_vm(self, model, ctx, t):
        rho = ctx.rho
        z = ctx.aux("orientation.Phi") / model.param_set.grav
        u_geo = torch.stack([ctx.aux("lsforcing.ua"), ctx.aux("lsforcing.va"),
                             torch.zeros_like(rho)], dim=1)
        beta = sponge_beta(z, self.z_sponge, self.z_max, self.alpha_max,
                           self.gamma)
        return {"rhou": -beta[:, None] * (ctx.rhou - rho[:, None] * u_geo)}
