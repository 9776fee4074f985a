"""Analytic reference profiles (port of
``climatemachine_tpu/physics/temperature_profiles.py`` :22-80: the
``TemperatureProfile`` base, ``DecayingTemperatureProfile``,
``IsothermalProfile`` and ``DryAdiabaticProfile``).

Each profile maps altitude z (a tensor) to ``(T_virt, p)`` in closed
form, in hydrostatic balance dp/dz = −g p / (R_d T_virt).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from climatemachine_tpu_torch.physics.parameters import PlanetParameterSet


class TemperatureProfile:
    def __call__(self, ps: PlanetParameterSet, z):
        raise NotImplementedError


@dataclass(frozen=True)
class DecayingTemperatureProfile(TemperatureProfile):
    """T_virt decays from T_virt_surf to T_min_ref on scale height H_t."""
    T_virt_surf: float = 290.0
    T_min_ref: float = 220.0
    H_t: Optional[float] = None   # default: R_d T_virt_surf / g

    def __call__(self, ps: PlanetParameterSet, z):
        R_d, grav, p_sfc = ps.R_d, ps.grav, ps.MSLP
        H_sfc = R_d * self.T_virt_surf / grav
        H_t = self.H_t if self.H_t is not None else H_sfc
        zp = z / H_t
        tanh_zp = torch.tanh(zp)
        dTv = self.T_virt_surf - self.T_min_ref
        Tv = self.T_virt_surf - dTv * tanh_zp
        dTvp = dTv / self.T_virt_surf
        lp = -H_t * (zp + dTvp * (torch.log(1 - dTvp * tanh_zp)
                                  - torch.log(1 + tanh_zp) + zp))
        lp = lp / (H_sfc * (1 - dTvp ** 2))
        return Tv, p_sfc * torch.exp(lp)


@dataclass(frozen=True)
class IsothermalProfile(TemperatureProfile):
    T_virt: float = 290.0

    def __call__(self, ps: PlanetParameterSet, z):
        T = torch.full_like(z, self.T_virt)
        p = ps.MSLP * torch.exp(-z * ps.grav / (ps.R_d * self.T_virt))
        return T, p


@dataclass(frozen=True)
class DryAdiabaticProfile(TemperatureProfile):
    """Dry-adiabatic lapse g/c_p up to T_min_ref, isothermal above."""
    T_surface: float = 290.0
    T_min_ref: float = 220.0

    def __call__(self, ps: PlanetParameterSet, z):
        R_d, cp_d, grav, p_sfc = ps.R_d, ps.cp_d, ps.grav, ps.MSLP
        lapse = grav / cp_d
        T = torch.clamp(self.T_surface - lapse * z, min=self.T_min_ref)
        # altitude of the isothermal transition
        z_t = (self.T_surface - self.T_min_ref) / lapse
        p_ad = p_sfc * torch.clamp(1 - lapse * torch.clamp(z, max=z_t)
                                   / self.T_surface, min=1e-12) ** (cp_d / R_d)
        p_t = p_sfc * (self.T_min_ref / self.T_surface) ** (cp_d / R_d)
        p_iso = p_t * torch.exp(-(z - z_t) * grav / (R_d * self.T_min_ref))
        return T, torch.where(z <= z_t, p_ad, p_iso)
