"""(Moist) baroclinic wave on the cubed sphere, the DCMIP2016 case (port
of ``climatemachine_tpu/experiments/baroclinic_wave.py`` :34-167:
``bcwave_base_state``, ``bcwave_perturbation``, ``moist_low_tropics_q``,
``baroclinic_wave_init`` and ``baroclinic_wave_config``).

The deep-atmosphere analytic base state of Ullrich et al. (2016) with a
localized velocity dipole and, moist, the low-tropics humidity profile;
EquilMoist with EquilMoistBiharmonic hyperdiffusion (DryModel with
DryBiharmonic when dry), optional passive tracers, Gravity and
Coriolis, free-slip insulating walls.  The initial state leaves every
lane past ρq_tot (the precipitation's and the tracers', of a model that
has them) at zero, as the JAX package's does.  Coordinates ``[E, 3,
Np]``, state and aux var-major ``[E, n, Np]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import AtmosBC
from climatemachine_tpu_torch.atmos.hyperdiffusion import (
    DryBiharmonic, EquilMoistBiharmonic)
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.moisture import DryModel, EquilMoist
from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
from climatemachine_tpu_torch.atmos.sources import Coriolis, Gravity
from climatemachine_tpu_torch.common.orientations import (
    SphericalOrientation, latitude, longitude, sphr_to_cart_vec)
from climatemachine_tpu_torch.mesh.grid import Grid, make_grid
from climatemachine_tpu_torch.mesh.topology import \
    stacked_cubed_sphere_topology
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import (EARTH,
                                                         PlanetParameterSet)
from climatemachine_tpu_torch.physics.temperature_profiles import (
    DecayingTemperatureProfile)


def bcwave_base_state(ps: PlanetParameterSet, phi, z):
    """(T_v, p, u_zonal) of the deep-atmosphere base state at latitude
    phi and altitude z."""
    g, R_d, Om, a, p0 = ps.grav, ps.R_d, ps.Omega, ps.planet_radius, ps.MSLP
    k = 3.0
    T_E, T_P = 310.0, 240.0
    T_0 = 0.5 * (T_E + T_P)
    Gam = 0.005
    A = 1 / Gam
    B = (T_0 - T_P) / (T_0 * T_P)
    C = 0.5 * (k + 2) * (T_E - T_P) / (T_E * T_P)
    b = 2.0
    H = R_d * T_0 / g
    gam = 1.0  # deep atmosphere

    tz1 = torch.exp(Gam * z / T_0)
    tz2 = 1 - 2 * (z / (b * H)) ** 2
    tz3 = torch.exp(-((z / (b * H)) ** 2))
    tau1 = tz1 / T_0 + B * tz2 * tz3
    tau2 = C * tz2 * tz3
    ti1 = A * (tz1 - 1) + B * z * tz3
    ti2 = C * z * tz3
    cr = torch.cos(phi) * (1 + gam * z / a)
    I_T = cr ** k - k / (k + 2) * cr ** (k + 2)

    T_v = 1.0 / (tau1 - tau2 * I_T)
    p = p0 * torch.exp(-g / R_d * (ti1 - ti2 * I_T))

    U = (g * k / a * ti2 * T_v * (cr ** (k - 1) - cr ** (k + 1)))
    rc = (a + gam * z) * torch.cos(phi)
    u_ref = -Om * rc + torch.sqrt(
        (Om * rc) ** 2 + torch.maximum(rc * U, -((Om * rc) ** 2)))
    return T_v, p, u_ref


def bcwave_perturbation(ps: PlanetParameterSet, phi, lam, z, V_p=1.0):
    """(u, v) of the localized velocity dipole."""
    a = ps.planet_radius
    z_t = 15e3
    lam_c, phi_c = np.pi / 9, 2 * np.pi / 9
    d_0 = a / 6
    zr = torch.clamp(z / z_t, 0.0, 1.0)
    F_z = torch.where(z > z_t, 0.0, 1 - 3 * zr ** 2 + 2 * zr ** 3)
    cosarg = torch.clamp(torch.sin(phi) * np.sin(phi_c)
                         + torch.cos(phi) * np.cos(phi_c)
                         * torch.cos(lam - lam_c), -1.0, 1.0)
    d = a * torch.arccos(cosarg)
    c3 = torch.cos(np.pi * d / 2 / d_0) ** 3
    s1 = torch.sin(np.pi * d / 2 / d_0)
    sda = torch.sin(d / a)
    safe = torch.where(torch.abs(sda) < 1e-12, 1.0, sda)
    coeff = 16 * V_p / (3 * np.sqrt(3.0)) * F_z * c3 * s1 / safe
    u_p = -coeff * (-np.sin(phi_c) * torch.cos(phi)
                    + np.cos(phi_c) * torch.sin(phi) * torch.cos(lam - lam_c))
    v_p = coeff * np.cos(phi_c) * torch.sin(lam - lam_c)
    active = (d > 0) & (d < d_0) & (torch.abs(sda) > 1e-12)
    return torch.where(active, u_p, 0.0), torch.where(active, v_p, 0.0)


def moist_low_tropics_q(ps: PlanetParameterSet, phi, p):
    """Specific humidity q_tot of the low-tropics profile."""
    p_w = 34e3
    eta_crit = p_w / ps.MSLP
    q_0, q_t = 0.018, 1e-12
    phi_w = 2 * np.pi / 9
    eta = p / ps.MSLP
    q = q_0 * torch.exp(-((phi / phi_w) ** 4)) \
        * torch.exp(-(((eta - 1) * ps.MSLP / p_w) ** 2))
    return torch.where(eta > eta_crit, q, q_t)


def baroclinic_wave_init(model, coords, aux, t):
    """The base state plus the perturbation, with the low-tropics q_tot
    under EquilMoist and zero on any further lane; var-major q ``[E, n,
    Np]``."""
    ps, sp = model.param_set, model.aux_spec
    phi, lam = latitude(coords), longitude(coords)
    Phi = sp.get(aux, "orientation.Phi")
    z = Phi / ps.grav

    T_v, p, u_ref = bcwave_base_state(ps, phi, z)
    u_p, v_p = bcwave_perturbation(ps, phi, lam, z)
    u_cart = sphr_to_cart_vec(
        coords, torch.stack([u_ref + u_p, v_p, torch.zeros_like(u_p)],
                            dim=1))

    if model.moist:
        q_tot = moist_low_tropics_q(ps, phi, p)
    else:
        q_tot = torch.zeros_like(p)
    eps = ps.molmass_ratio
    T = T_v / (1 + (eps - 1) * q_tot)
    pp = td.PhasePartition.vapor(q_tot)
    rho = p / (td.gas_constant_air(ps, pp) * T)
    ke = 0.5 * torch.sum(u_cart * u_cart, dim=1)
    e_int = td.internal_energy(ps, T, pp)
    parts = [rho[:, None], rho[:, None] * u_cart,
             (rho * (e_int + ke + Phi))[:, None]]
    if model.moist:
        parts.append((rho * q_tot)[:, None])
    n = model.prog_spec.num - sum(p.shape[1] for p in parts)
    parts.append(rho.new_zeros((rho.shape[0], n, rho.shape[1])))
    return torch.cat(parts, dim=1)


@dataclass
class BaroclinicWaveConfig:
    model: AtmosModel
    grid: Grid


def baroclinic_wave_config(n_horz: int = 8, n_vert: int = 4,
                           poly_order: int = 4, domain_height: float = 30e3,
                           moist: bool = True, tracers=None, dtype=None,
                           param_set: PlanetParameterSet = EARTH,
                           hyperdiffusion_tau: float = 8 * 3600.0,
                           device=None) -> BaroclinicWaveConfig:
    """(model, grid) of the baroclinic wave on a stacked cubed sphere: a
    DecayingTemperatureProfile(290, 220, 8e3) reference state, Gravity
    and Coriolis, and, unless ``hyperdiffusion_tau`` is None or 0,
    EquilMoistBiharmonic (moist) or DryBiharmonic (dry) with that
    timescale; ``tracers`` None or an
    :class:`~climatemachine_tpu_torch.atmos.tracers.NTracers`.
    ``dtype=None`` means float32, ``device=None`` CUDA."""
    a = param_set.planet_radius
    vert_range = a + np.linspace(0.0, domain_height, n_vert + 1)
    topo = stacked_cubed_sphere_topology(n_horz, vert_range)
    grid = make_grid(topo, poly_order, dtype=dtype or torch.float32,
                     device=device)
    hyper = None
    if hyperdiffusion_tau:
        hyper = (EquilMoistBiharmonic(hyperdiffusion_tau) if moist
                 else DryBiharmonic(hyperdiffusion_tau))
    physics = AtmosPhysics(
        param_set=param_set, orientation=SphericalOrientation(),
        ref_state=HydrostaticState(
            DecayingTemperatureProfile(290.0, 220.0, 8e3)),
        moisture=EquilMoist() if moist else DryModel(),
        tracers=tracers, hyperdiffusion=hyper)
    problem = AtmosProblem(init_state=baroclinic_wave_init,
                           boundary_conditions=(AtmosBC(), AtmosBC()))
    model = AtmosModel(physics, problem, sources=(Gravity(), Coriolis()))
    return BaroclinicWaveConfig(model=model, grid=grid)
