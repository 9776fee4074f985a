"""Physical constants (port of ``climatemachine_tpu/physics/parameters.py``,
the dry and moist subset the Held-Suarez step, the moist baroclinic
wave and the turbulence closures read).  Plain Python floats with the same values as the JAX
package's Earth set."""

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
    # water
    molmass_water: float = 18.01528e-3     # kg/mol
    cp_v: float = 1859.0                   # J/kg/K vapor isobaric heat cap
    cp_l: float = 4181.0                   # liquid
    cp_i: float = 2100.0                   # ice
    T_min: float = 150.0                   # K saturation-adjust lower bound
    T_max: float = 1000.0                  # K saturation-adjust upper bound
    T_freeze: float = 273.15               # K freezing point
    T_triple: float = 273.16               # K triple point
    press_triple: float = 611.657          # Pa triple-point vapor pressure
    LH_v0: float = 2.5008e6                # J/kg latent heat vaporization @T_0
    LH_s0: float = 2.8344e6                # J/kg latent heat sublimation @T_0
    # subgrid scale
    C_smag: float = 0.21
    Prandtl_turb: float = 1.0 / 3.0
    C_drag: float = 0.0044                 # surface bulk-transfer coefficient

    @property
    def inv_Pr_turb(self) -> float:
        return 1.0 / self.Prandtl_turb

    @property
    def R_d(self) -> float:
        return self.gas_constant / self.molmass_dryair

    @property
    def cp_d(self) -> float:
        return self.R_d / self.kappa_d

    @property
    def cv_d(self) -> float:
        return self.cp_d - self.R_d

    @property
    def R_v(self) -> float:
        return self.gas_constant / self.molmass_water

    @property
    def molmass_ratio(self) -> float:
        return self.molmass_dryair / self.molmass_water

    @property
    def cv_v(self) -> float:
        return self.cp_v - self.R_v

    @property
    def cv_l(self) -> float:
        return self.cp_l

    @property
    def cv_i(self) -> float:
        return self.cp_i

    @property
    def LH_f0(self) -> float:
        return self.LH_s0 - self.LH_v0

    @property
    def e_int_v0(self) -> float:
        """Vapour specific internal energy at T_0."""
        return self.LH_v0 - self.R_v * self.T_0

    @property
    def e_int_i0(self) -> float:
        """Ice specific internal energy offset (fusion) at T_0."""
        return self.LH_f0


EARTH = PlanetParameterSet()
