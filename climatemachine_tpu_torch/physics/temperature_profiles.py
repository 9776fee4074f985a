"""Analytic reference profiles (port of
``climatemachine_tpu/physics/temperature_profiles.py``,
``DecayingTemperatureProfile``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from climatemachine_tpu_torch.physics.parameters import PlanetParameterSet


@dataclass(frozen=True)
class DecayingTemperatureProfile:
    """T_virt decays from T_virt_surf to T_min_ref on scale height H_t;
    returns ``(T_virt, p)`` in hydrostatic balance at altitude z."""
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
