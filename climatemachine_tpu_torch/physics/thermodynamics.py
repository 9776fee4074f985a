"""Moist-air thermodynamics (port of
``climatemachine_tpu/physics/thermodynamics.py``): the equation of
state, the saturation adjustment, the potential temperatures, relative
humidity and enthalpy, and T from (p, θ_liq[, q_tot]), the same
formulas in the same evaluation order, on tensors.

``q`` is a :class:`PhasePartition` (total, liquid and ice specific
humidities); ``None`` means dry air, whose formulas are the dry limits
the Held-Suarez step runs.  The saturation adjustment keeps the JAX
package's static trip counts (30 bisections, then ``n_iter`` Newton
steps): its float32 result depends on them.  So does
:func:`temperature_from_theta_liq`, 30 bisections whose test
``θ_liq(mid) < θ_liq`` keeps the JAX package's order: a comparison that
flips on round-off moves T by the bracket width of that step, at most
(T_max − T_min)/2³⁰ after the last.
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


def internal_energy_from_state(rho, rhoe, rhou, Phi):
    """e_int = ρe/ρ − |ρu|²/2ρ² − Φ of a conserved state (ρu ``[E, 3,
    L]``: the vector axis is 1)."""
    ke = 0.5 * torch.sum(rhou * rhou, dim=1) / (rho * rho)
    return rhoe / rho - ke - Phi


def total_energy(ps: PlanetParameterSet, e_kin, e_pot, T,
                 q: Optional[PhasePartition] = None):
    """Specific total energy e_kin + e_pot + e_int(T, q)."""
    return e_kin + e_pot + internal_energy(ps, T, q)


# --- equation of state ---------------------------------------------------------

def air_pressure(ps: PlanetParameterSet, T, rho,
                 q: Optional[PhasePartition] = None):
    if q is None:
        return rho * ps.R_d * T
    return rho * gas_constant_air(ps, q) * T


def air_density(ps: PlanetParameterSet, T, p,
                q: Optional[PhasePartition] = None):
    return p / (gas_constant_air(ps, q) * T)


def soundspeed_air(ps: PlanetParameterSet, T,
                   q: Optional[PhasePartition] = None):
    gamma = cp_m(ps, q) / cv_m(ps, q)
    return torch.sqrt(gamma * gas_constant_air(ps, q) * T)


def exner(ps: PlanetParameterSet, p, q: Optional[PhasePartition] = None):
    """Π = (p/p₀)^(R_m/c_pm) (dry: κ_d)."""
    if q is None:
        return (p / ps.MSLP) ** ps.kappa_d
    return (p / ps.MSLP) ** (gas_constant_air(ps, q) / cp_m(ps, q))


def dry_pottemp(ps: PlanetParameterSet, T, p,
                q: Optional[PhasePartition] = None):
    return T / exner(ps, p, q)


def virtual_temperature(ps: PlanetParameterSet, T,
                        q: Optional[PhasePartition] = None):
    return gas_constant_air(ps, q) / ps.R_d * T


def liquid_ice_pottemp(ps: PlanetParameterSet, T, p,
                       q: Optional[PhasePartition] = None):
    """θ_li = θ (1 − (L_v q_l + L_s q_i)/(c_pm T)); dry air: θ."""
    theta = dry_pottemp(ps, T, p, q)
    if q is None:
        return theta
    return theta * (1.0 - (ps.LH_v0 * q.liq + ps.LH_s0 * q.ice)
                    / (cp_m(ps, q) * T))


def virtual_pottemp(ps: PlanetParameterSet, T, p,
                    q: Optional[PhasePartition] = None):
    """θ_v = (R_m/R_d) θ."""
    return gas_constant_air(ps, q) / ps.R_d * dry_pottemp(ps, T, p, q)


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


def relative_humidity(ps: PlanetParameterSet, T, p,
                      q: Optional[PhasePartition] = None):
    """p_vap / p_vap,sat over the λ(T)-weighted liquid/ice mixture,
    clipped to [0, 1]; dry air 0."""
    if q is None:
        return torch.zeros_like(T)
    q_vap = q.tot - q.liq - q.ice
    eps_vi = ps.R_v / ps.R_d
    p_vap = q_vap * p / (q_vap + (1.0 / eps_vi) * (1 - q.tot))
    lam = liquid_fraction(ps, T)
    pvs = (lam * saturation_vapor_pressure_liquid(ps, T)
           + (1 - lam) * saturation_vapor_pressure_ice(ps, T))
    return torch.clamp(p_vap / pvs, 0.0, 1.0)


def total_specific_enthalpy(ps: PlanetParameterSet, e_tot, T,
                            q: Optional[PhasePartition] = None):
    """h_tot = e_tot + R_m T."""
    return e_tot + gas_constant_air(ps, q) * T


def temperature_from_theta_liq(ps: PlanetParameterSet, p, theta_liq,
                               q_tot=None):
    """T from (p, θ_liq[, q_tot]).  Dry: T = θ Π.  Moist: 30 bisections
    of [T_min, T_max] on θ_liq(T) at fixed (p, q_tot), θ_liq(T) the
    liquid-ice potential temperature of the equilibrium phase partition
    at ρ = p/(R_m(q_tot) T), which increases with T; the midpoint of the
    last bracket."""
    if q_tot is None:
        return theta_liq * exner(ps, p)
    # liquid_ice_pottemp's arithmetic, with what does not depend on T
    # taken out of the loop and c_pm computed once an evaluation
    R_vap = gas_constant_air(ps, PhasePartition.vapor(q_tot))
    p_rel = p / ps.MSLP

    def theta_liq_of(T):
        pp = phase_partition_equil(ps, T, p / (R_vap * T), q_tot)
        cpm = cp_m(ps, pp)
        theta = T / p_rel ** (gas_constant_air(ps, pp) / cpm)
        return theta * (1.0 - (ps.LH_v0 * pp.liq + ps.LH_s0 * pp.ice)
                        / (cpm * T))

    lo = torch.full_like(theta_liq, ps.T_min)
    hi = torch.full_like(theta_liq, ps.T_max)
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        below = theta_liq_of(mid) < theta_liq
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)
