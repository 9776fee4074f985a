"""Reference states (port of ``climatemachine_tpu/atmos/ref_state.py``:
``ReferenceState`` and ``NoReferenceState`` :22-32, ``HydrostaticState``
:36-60)."""

from __future__ import annotations

from dataclasses import dataclass, field

from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import PlanetParameterSet
from climatemachine_tpu_torch.physics.temperature_profiles import (
    DecayingTemperatureProfile)
from climatemachine_tpu_torch.utils.variables import VarSpec


class ReferenceState:
    """No aux lanes, nothing taken out of the fluxes or sources."""

    def vars_aux(self) -> VarSpec:
        return VarSpec()

    @property
    def subtract_off(self) -> bool:
        return False


class NoReferenceState(ReferenceState):
    """The AtmosPhysics default."""


def reads_p_ref(dg) -> bool:
    """True where the RHS of the DGModel ``dg`` reads the reference
    pressure: its reference state takes it out of the momentum flux, or
    its remainder's linear model needs it."""
    return dg.balance_law.ref_state.subtract_off or dg.remainder is not None


@dataclass(frozen=True)
class HydrostaticState(ReferenceState):
    """Dry hydrostatic state from a virtual-temperature profile, closed
    form at every node.  With ``_subtract_off`` (the default) the
    reference pressure is taken out of the momentum flux and the
    reference density out of the gravity source."""
    profile: DecayingTemperatureProfile = field(
        default_factory=DecayingTemperatureProfile)
    _subtract_off: bool = True

    def vars_aux(self) -> VarSpec:
        return VarSpec(rho=1, p=1, T=1, rhoe=1)

    @property
    def subtract_off(self) -> bool:
        return self._subtract_off

    def fields(self, ps: PlanetParameterSet, z, Phi):
        """(rho, p, T, rhoe) at altitude z with geopotential Phi."""
        T_virt, p = self.profile(ps, z)
        rho = p / (ps.R_d * T_virt)
        rhoe = rho * (td.internal_energy(ps, T_virt) + Phi)
        return {"rho": rho, "p": p, "T": T_virt, "rhoe": rhoe}
