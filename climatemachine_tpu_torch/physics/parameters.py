"""Physical constants (port of ``climatemachine_tpu/physics/parameters.py``,
the dry subset the Held-Suarez step reads).  Plain Python floats with the
same values as the JAX package's Earth set."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PlanetParameterSet:
    gas_constant: float = 8.3144598        # J/mol/K
    grav: float = 9.81                     # m/s^2
    planet_radius: float = 6.371e6         # m
    day: float = 86400.0                   # s
    Omega: float = 7.2921159e-5            # 1/s planetary rotation rate
    MSLP: float = 1.01325e5                # Pa mean sea-level pressure
    molmass_dryair: float = 28.97e-3       # kg/mol
    kappa_d: float = 2.0 / 7.0             # R_d / cp_d
    T_0: float = 273.16                    # K thermodynamic reference temp

    @property
    def R_d(self) -> float:
        return self.gas_constant / self.molmass_dryair

    @property
    def cp_d(self) -> float:
        return self.R_d / self.kappa_d

    @property
    def cv_d(self) -> float:
        return self.cp_d - self.R_d


EARTH = PlanetParameterSet()
