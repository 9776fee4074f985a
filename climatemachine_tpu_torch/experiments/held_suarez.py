"""Dry Held-Suarez GCM (port of
``climatemachine_tpu/experiments/held_suarez.py``: held_suarez_config
:153, HeldSuarezForcing.contributions :45 and contributions_vm :76,
held_suarez_init :105, HeldSuarezStepFilter.apply_vm :216; and of
``examples/heldsuarez.py`` :33-51, the run through the driver entry,
:func:`held_suarez_driver` and the command line below).

Everything is var-major: coordinates ``[E, 3, Np]``, state and aux
``[E, n, Np]``.

    python -m climatemachine_tpu_torch.experiments.held_suarez \
        [--n-horz 4] [--n-vert 3] [--poly 4] [--timeend 600] [--imex] \
        [--device cpu] [driver settings: --checkpoint 10steps
        --checkpoint-at-end true --restart-from-num N --adapt-timestep
        5steps --monitor-courant-numbers 5steps
        --monitor-timestep-duration 5steps --show-updates 10steps ...]
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import AtmosBC
from climatemachine_tpu_torch.atmos.hyperdiffusion import DryBiharmonic
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
from climatemachine_tpu_torch.atmos.sources import Coriolis, Gravity, Source
from climatemachine_tpu_torch.common.orientations import (
    SphericalOrientation, latitude, longitude, sphr_to_cart_vec)
from climatemachine_tpu_torch.mesh.filters import ExponentialFilter
from climatemachine_tpu_torch.mesh.grid import Grid, make_grid
from climatemachine_tpu_torch.mesh.topology import \
    stacked_cubed_sphere_topology
from climatemachine_tpu_torch.physics.parameters import (EARTH,
                                                         PlanetParameterSet)
from climatemachine_tpu_torch.physics.temperature_profiles import (
    DecayingTemperatureProfile)


class HeldSuarezForcing(Source):
    """Held & Suarez (1994) relaxation of temperature to the equilibrium
    profile and Rayleigh damping of low-level winds."""

    T_ref = 255.0
    dT_y = 60.0
    dtheta_z = 10.0
    T_equator = 315.0
    T_min = 200.0
    sigma_b = 7.0 / 10.0

    def contributions_vm(self, model, ctx, t):
        ps = model.param_set
        day = ps.day
        k_a, k_f, k_s = 1 / (40 * day), 1 / day, 1 / (4 * day)
        rho, rhou, T, p = ctx.rho, ctx.rhou, ctx.T, ctx.p
        coords = ctx.coords
        r = torch.sqrt(torch.sum(coords * coords, dim=1))
        phi = torch.arcsin(torch.clamp(coords[:, 2] / r, -1.0, 1.0))
        sigma = p / ps.MSLP
        exner_p = sigma ** (ps.R_d / ps.cp_d)
        height_factor = torch.clamp_min(
            (sigma - self.sigma_b) / (1 - self.sigma_b), 0.0)
        cosphi2 = torch.cos(phi) ** 2
        T_equil = (self.T_equator - self.dT_y * torch.sin(phi) ** 2
                   - self.dtheta_z * torch.log(sigma) * cosphi2) * exner_p
        T_equil = torch.clamp_min(T_equil, self.T_min)
        k_T = k_a + (k_s - k_a) * height_factor * cosphi2 ** 2
        k_v = k_f * height_factor
        k = ctx.grad_Phi / ps.grav
        rhou_tan = rhou - torch.sum(rhou * k, dim=1, keepdim=True) * k
        return {"rhou": -k_v[:, None, :] * rhou_tan,
                "rhoe": -k_T * rho * ps.cv_d * (T - T_equil)}


def held_suarez_init(model, coords, aux, t):
    """Reference-state start plus a deterministic velocity perturbation;
    returns var-major q ``[E, 5, Np]``."""
    ps, sp = model.param_set, model.aux_spec
    a = ps.planet_radius
    z_t, V_p = 15e3, 10.0
    lam_c, phi_c = np.pi / 9, 2 * np.pi / 9
    d_0 = a / 6

    phi, lam = latitude(coords), longitude(coords)
    z = sp.get(aux, "orientation.Phi") / ps.grav
    zr = torch.clamp(z / z_t, 0.0, 1.0)
    F_z = torch.where(z > z_t, 0.0, 1 - 3 * zr ** 2 + 2 * zr ** 3)
    cosarg = torch.clamp(torch.sin(phi) * np.sin(phi_c)
                         + torch.cos(phi) * np.cos(phi_c)
                         * torch.cos(lam - lam_c), -1.0, 1.0)
    d = a * torch.arccos(cosarg)
    c3 = torch.cos(np.pi * d / 2 / d_0) ** 3
    s1 = torch.sin(np.pi * d / 2 / d_0)
    sin_d_a = torch.sin(d / a)
    safe = torch.where(torch.abs(sin_d_a) < 1e-12, 1.0, sin_d_a)
    coeff = 16 * V_p / (3 * math.sqrt(3.0)) * F_z * c3 * s1 / safe
    u_p = -coeff * (-np.sin(phi_c) * torch.cos(phi)
                    + np.cos(phi_c) * torch.sin(phi) * torch.cos(lam - lam_c))
    v_p = coeff * np.cos(phi_c) * torch.sin(lam - lam_c)
    active = (d > 0) & (d < d_0) & (torch.abs(sin_d_a) > 1e-12)
    u_p = torch.where(active, u_p, 0.0)
    v_p = torch.where(active, v_p, 0.0)

    u_cart = sphr_to_cart_vec(
        coords, torch.stack([u_p, v_p, torch.zeros_like(u_p)], dim=1))
    rho = sp.get(aux, "ref_state.rho")
    rhoe_ref = sp.get(aux, "ref_state.rhoe")
    e_kin = 0.5 * torch.sum(u_cart * u_cart, dim=1)
    return torch.cat([rho[:, None], rho[:, None] * u_cart,
                      (rhoe_ref + rho * e_kin)[:, None]], dim=1)


@dataclass
class HeldSuarezConfig:
    model: AtmosModel
    grid: Grid


def held_suarez_config(n_horz: int = 8, n_vert: int = 4, poly_order: int = 5,
                       domain_height: float = 30e3, dtype=None,
                       param_set: PlanetParameterSet = EARTH,
                       hyperdiffusion_tau: float = 8 * 3600.0,
                       device=None) -> HeldSuarezConfig:
    """(model, grid) for Held-Suarez on a stacked cubed sphere with a
    DecayingTemperatureProfile(290, 220, 8e3) reference state, the
    Gravity, Coriolis and Held-Suarez sources and, unless
    ``hyperdiffusion_tau`` is None or 0, ``DryBiharmonic`` horizontal
    hyperdiffusion with that timescale.  ``dtype=None`` means float32,
    ``device=None`` CUDA."""
    a = param_set.planet_radius
    vert_range = a + np.linspace(0.0, domain_height, n_vert + 1)
    topo = stacked_cubed_sphere_topology(n_horz, vert_range)
    grid = make_grid(topo, poly_order, dtype=dtype or torch.float32,
                     device=device)
    physics = AtmosPhysics(
        param_set=param_set, orientation=SphericalOrientation(),
        ref_state=HydrostaticState(
            DecayingTemperatureProfile(290.0, 220.0, 8e3)),
        hyperdiffusion=(DryBiharmonic(hyperdiffusion_tau)
                        if hyperdiffusion_tau else None))
    problem = AtmosProblem(init_state=held_suarez_init,
                           boundary_conditions=(AtmosBC(), AtmosBC()))
    model = AtmosModel(physics, problem,
                       sources=(Gravity(), Coriolis(), HeldSuarezForcing()))
    return HeldSuarezConfig(model=model, grid=grid)


class HeldSuarezStepFilter:
    """Every-step exponential filter (Nc = 0, order 20) on perturbations
    about the reference state: ρ and ρe lose their reference values before
    filtering and get them back after.  Use ``apply_vm`` as the time
    integrator's ``post_step``."""

    def __init__(self, grid, model, order: int = 20):
        self.filt = ExponentialFilter(grid, 0, order)
        self.i_rho = model.prog_spec.index("rho").start
        self.i_rhoe = model.prog_spec.index("rhoe").start
        self.i_rho_ref = model.aux_spec.index("ref_state.rho").start
        self.i_rhoe_ref = model.aux_spec.index("ref_state.rhoe").start

    def apply_vm(self, qv, auxv):
        ref = torch.zeros_like(qv)
        ref[:, self.i_rho] = auxv[:, self.i_rho_ref]
        ref[:, self.i_rhoe] = auxv[:, self.i_rhoe_ref]
        return self.filt.apply_vm(qv - ref) + ref


def held_suarez_driver(n_horz: int = 4, n_vert: int = 3, poly_order: int = 4,
                       timeend: float = 600.0, imex: bool = False,
                       dtype=torch.float32, device=None,
                       hyperdiffusion_tau: float = 8 * 3600.0,
                       restart_from=None, ode_dt=None):
    """The solver configuration of examples/heldsuarez.py: a
    ``DriverConfiguration`` of :func:`held_suarez_config` (with the GCM
    shell's ``config_info``, as ``AtmosGCMConfiguration`` gives it),
    ``make_solver_configuration(0, timeend, ..., IMEXSolverType() or
    ExplicitSolverType(), Courant_number=0.3)`` (dt as given by
    ``ode_dt``, or from the checkpoint ``restart_from`` = (directory,
    num) on), and :class:`HeldSuarezStepFilter`'s ``apply_vm`` as the
    solver's ``post_step``; run it with ``driver.invoke``."""
    from climatemachine_tpu_torch.driver.configs import DriverConfiguration
    from climatemachine_tpu_torch.driver.solver_configs import \
        make_solver_configuration
    from climatemachine_tpu_torch.driver.solver_types import (
        ExplicitSolverType, IMEXSolverType)
    cfg = held_suarez_config(n_horz=n_horz, n_vert=n_vert,
                             poly_order=poly_order, dtype=dtype,
                             hyperdiffusion_tau=hyperdiffusion_tau,
                             device=device)
    dc = DriverConfiguration("heldsuarez", poly_order, cfg.grid, cfg.model,
                             config_info=dict(n_horz=n_horz, n_vert=n_vert,
                                              domain_height=30e3))
    sc = make_solver_configuration(
        0.0, timeend, dc,
        ode_solver_type=IMEXSolverType() if imex else ExplicitSolverType(),
        Courant_number=0.3, ode_dt=ode_dt, restart_from=restart_from)
    sc.solver.post_step = HeldSuarezStepFilter(cfg.grid, cfg.model).apply_vm
    return sc


def main(argv=None):
    import argparse

    from climatemachine_tpu_torch.driver import driver
    ap = argparse.ArgumentParser(description="Held-Suarez through the "
                                 "driver entry")
    ap.add_argument("--n-horz", type=int, default=4)
    ap.add_argument("--n-vert", type=int, default=3)
    ap.add_argument("--poly", type=int, default=4)
    ap.add_argument("--timeend", type=float, default=600.0)
    ap.add_argument("--imex", action="store_true",
                    help="HEVI IMEX (ARK2GKC and the column solve)")
    ap.add_argument("--device", default=None)
    args, _ = ap.parse_known_args(argv)
    settings = driver.init(parse_clargs=True, argv=argv)
    device = args.device or ("cpu" if settings.disable_gpu else None)
    restart = None
    if settings.restart_from_num >= 0:
        restart = (settings.checkpoint_dir, settings.restart_from_num)
    sc = held_suarez_driver(args.n_horz, args.n_vert, args.poly,
                            args.timeend, args.imex, device=device,
                            dtype=torch.float64 if device == "cpu"
                            else torch.float32, restart_from=restart)
    print(f"dt = {sc.dt:.2f} s, elements = {sc.dg.grid.nelem}, "
          f"solver = {'IMEX' if args.imex else 'explicit LSRK'}, "
          f"t0 = {sc.t0:.1f} s", flush=True)
    ratio = driver.invoke(sc)
    print(f"norm(Q)/norm(Q0) = {ratio:.6f}", flush=True)


if __name__ == "__main__":
    main()
