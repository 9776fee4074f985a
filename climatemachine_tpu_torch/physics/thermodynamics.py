"""Moist-air thermodynamics (port of
``climatemachine_tpu/physics/thermodynamics.py`` :27-242): the equation
of state and the saturation adjustment, the same formulas in the same
evaluation order, on tensors.

``q`` is a :class:`PhasePartition` (total, liquid and ice specific
humidities); ``None`` means dry air, whose formulas are the dry limits
the Held-Suarez step runs.  The saturation adjustment keeps the JAX
package's static trip counts (30 bisections, then ``n_iter`` Newton
steps): its float32 result depends on them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from climatemachine_tpu_torch.physics.parameters import PlanetParameterSet


class PhasePartition(NamedTuple):
    """Specific humidities [kg/kg]: total, liquid, ice."""
    tot: torch.Tensor
    liq: torch.Tensor
    ice: torch.Tensor

    @staticmethod
    def vapor(q_tot):
        z = torch.zeros_like(q_tot)
        return PhasePartition(q_tot, z, z)

    @property
    def vap(self):
        return self.tot - self.liq - self.ice


# --- moist-air material properties ------------------------------------------

def gas_constant_air(ps: PlanetParameterSet,
                     q: Optional[PhasePartition] = None):
    """R_m, the specific gas constant of moist air."""
    if q is None:
        return ps.R_d
    eps = ps.molmass_ratio
    return ps.R_d * (1 + (eps - 1) * q.tot - eps * (q.liq + q.ice))


def cv_m(ps: PlanetParameterSet, q: Optional[PhasePartition] = None):
    if q is None:
        return ps.cv_d
    return (ps.cv_d + (ps.cv_v - ps.cv_d) * q.tot
            + (ps.cv_l - ps.cv_v) * q.liq + (ps.cv_i - ps.cv_v) * q.ice)


def cp_m(ps: PlanetParameterSet, q: Optional[PhasePartition] = None):
    if q is None:
        return ps.cp_d
    return (ps.cp_d + (ps.cp_v - ps.cp_d) * q.tot
            + (ps.cp_l - ps.cp_v) * q.liq + (ps.cp_i - ps.cp_v) * q.ice)


# --- internal energy <-> temperature ------------------------------------------

def internal_energy(ps: PlanetParameterSet, T,
                    q: Optional[PhasePartition] = None):
    """Specific internal energy e_int(T, q)."""
    if q is None:
        return ps.cv_d * (T - ps.T_0)
    return (cv_m(ps, q) * (T - ps.T_0)
            + (q.tot - q.liq) * ps.e_int_v0
            - q.ice * (ps.e_int_v0 + ps.e_int_i0))


def air_temperature(ps: PlanetParameterSet, e_int,
                    q: Optional[PhasePartition] = None):
    """T(e_int, q), the inverse of :func:`internal_energy`."""
    if q is None:
        return ps.T_0 + e_int / ps.cv_d
    return ps.T_0 + (e_int - (q.tot - q.liq) * ps.e_int_v0
                     + q.ice * (ps.e_int_v0 + ps.e_int_i0)) / cv_m(ps, q)


# --- equation of state ---------------------------------------------------------

def air_pressure(ps: PlanetParameterSet, T, rho,
                 q: Optional[PhasePartition] = None):
    if q is None:
        return rho * ps.R_d * T
    return rho * gas_constant_air(ps, q) * T


def soundspeed_air(ps: PlanetParameterSet, T,
                   q: Optional[PhasePartition] = None):
    gamma = cp_m(ps, q) / cv_m(ps, q)
    return torch.sqrt(gamma * gas_constant_air(ps, q) * T)


def virtual_temperature(ps: PlanetParameterSet, T,
                        q: Optional[PhasePartition] = None):
    return gas_constant_air(ps, q) / ps.R_d * T


# --- saturation ------------------------------------------------------------------

def liquid_fraction(ps: PlanetParameterSet, T):
    """Equilibrium liquid fraction λ(T): 1 above freezing, else 0."""
    return (T > ps.T_freeze).to(T.dtype)


def saturation_vapor_pressure(ps: PlanetParameterSet, T, LH_0, dcp):
    """Clausius-Clapeyron with a latent heat linear in T."""
    Tt, Rv, T0 = ps.T_triple, ps.R_v, ps.T_0
    return (ps.press_triple * (T / Tt) ** (dcp / Rv)
            * torch.exp((LH_0 - dcp * T0) / Rv * (1 / Tt - 1 / T)))


def saturation_vapor_pressure_liquid(ps: PlanetParameterSet, T):
    return saturation_vapor_pressure(ps, T, ps.LH_v0, ps.cp_v - ps.cp_l)


def saturation_vapor_pressure_ice(ps: PlanetParameterSet, T):
    return saturation_vapor_pressure(ps, T, ps.LH_s0, ps.cp_v - ps.cp_i)


def q_vap_saturation(ps: PlanetParameterSet, T, rho, lam=None):
    """Saturation specific humidity over a λ-weighted liquid/ice
    mixture."""
    if lam is None:
        lam = liquid_fraction(ps, T)
    pvs = (lam * saturation_vapor_pressure_liquid(ps, T)
           + (1 - lam) * saturation_vapor_pressure_ice(ps, T))
    return pvs / (rho * ps.R_v * T)


def latent_heat_vapor(ps: PlanetParameterSet, T):
    return ps.LH_v0 + (ps.cp_v - ps.cp_l) * (T - ps.T_0)


def latent_heat_sublim(ps: PlanetParameterSet, T):
    return ps.LH_s0 + (ps.cp_v - ps.cp_i) * (T - ps.T_0)


def latent_heat_fusion(ps: PlanetParameterSet, T):
    return ps.LH_f0 + (ps.cp_l - ps.cp_i) * (T - ps.T_0)


def phase_partition_equil(ps: PlanetParameterSet, T, rho, q_tot):
    """The equilibrium phase partition at temperature T."""
    lam = liquid_fraction(ps, T)
    q_sat = q_vap_saturation(ps, T, rho, lam)
    excess = torch.clamp_min(q_tot - q_sat, 0.0)
    return PhasePartition(q_tot, lam * excess, (1 - lam) * excess)


def saturation_adjustment(ps: PlanetParameterSet, e_int, rho, q_tot,
                          n_iter: int = 6, n_bisect: int = 30):
    """The equilibrium temperature T with e_int = internal_energy(T,
    q_eq(T)): ``n_bisect`` bisections of [T_min, T_max], then ``n_iter``
    Newton steps with a forward-difference slope (dT = 1e-3), each kept
    inside the bisection bracket.  Points that are unsaturated at the
    all-vapour temperature take that temperature."""
    T_vap = air_temperature(ps, e_int, PhasePartition.vapor(q_tot))
    T_vap = torch.clamp(T_vap, ps.T_min, ps.T_max)
    unsaturated = q_tot <= q_vap_saturation(ps, T_vap, rho)

    def resid(T):
        q = phase_partition_equil(ps, T, rho, q_tot)
        return internal_energy(ps, T, q) - e_int

    lo = torch.full_like(T_vap, ps.T_min)
    hi = torch.full_like(T_vap, ps.T_max)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        below = resid(mid) < 0
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    T = 0.5 * (lo + hi)

    dT = 1e-3
    for _ in range(n_iter):
        f = resid(T)
        df = (resid(T + dT) - f) / dT
        Tn = T - f / torch.where(torch.abs(df) < 1e-12, 1e-12, df)
        T = torch.clamp(Tn, lo, hi)
    return torch.where(unsaturated, T_vap, T)
