"""Hydrostatic reference state (port of
``climatemachine_tpu/atmos/ref_state.py``, ``HydrostaticState`` :36)."""

from __future__ import annotations

from dataclasses import dataclass, field

from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import PlanetParameterSet
from climatemachine_tpu_torch.physics.temperature_profiles import (
    DecayingTemperatureProfile)
from climatemachine_tpu_torch.utils.variables import VarSpec


@dataclass(frozen=True)
class HydrostaticState:
    """Dry hydrostatic state from a virtual-temperature profile, closed
    form at every node.  The reference pressure is always taken out of
    the momentum flux and the reference density out of the gravity
    source (the JAX package's ``subtract_off`` default, the only mode the
    Held-Suarez step uses)."""
    profile: DecayingTemperatureProfile = field(
        default_factory=DecayingTemperatureProfile)

    def vars_aux(self) -> VarSpec:
        return VarSpec(rho=1, p=1, T=1, rhoe=1)

    def fields(self, ps: PlanetParameterSet, z, Phi):
        """(rho, p, T, rhoe) at altitude z with geopotential Phi."""
        T_virt, p = self.profile(ps, z)
        rho = p / (ps.R_d * T_virt)
        rhoe = rho * (td.internal_energy(ps, T_virt) + Phi)
        return {"rho": rho, "p": p, "T": T_virt, "rhoe": rhoe}
