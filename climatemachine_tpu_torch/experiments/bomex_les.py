"""BOMEX, the shallow-cumulus LES intercomparison of Siebesma et al.
(2003) (the port's counterpart of ``examples/bomex_les.py``): a 6.4 ×
6.4 × 3 km box at Δx = Δy = 100 m, Δz = 40 m, p4 and float64 (16 × 16 ×
19 elements), equilibrium moisture (``EquilMoist(maxiter=5)``),
SmagorinskyLilly(0.23), the BOMEX forcings (the large-scale moisture
sink, the radiative cooling and the subsidence of h_tot and q_tot,
``BomexTendencies``; the geostrophic wind sloped with height,
``BomexGeostrophic``; a Rayleigh sponge toward it above 2400 m,
``BomexSponge``), a u*-pinned surface drag and prescribed (or bulk)
surface heat and moisture fluxes, and TMAR on ρq_tot after every step.

Built through the driver's entry: :func:`bomex_config` gives the
``AtmosLESConfiguration``, :func:`tmar_callback` the per-step positivity
callback for ``invoke``.  CLI (a few steps on the CPU)::

    python -m climatemachine_tpu_torch.experiments.bomex_les \\
        --resolution 800 800 375 --timeend 3 --device cpu
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import (
    AtmosBC, BulkFormulaEnergy, BulkFormulaMoisture, DragLaw, Impenetrable,
    PrescribedEnergyFlux, PrescribedMoistureFlux)
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.moisture import EquilMoist
from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
from climatemachine_tpu_torch.atmos.sources import (Gravity, Source,
                                                    sponge_beta)
from climatemachine_tpu_torch.common.turbulence import SmagorinskyLilly
from climatemachine_tpu_torch.driver.callbacks import EveryXSimulationSteps
from climatemachine_tpu_torch.driver.configs import AtmosLESConfiguration
from climatemachine_tpu_torch.mesh.filters import tmar
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import EARTH
from climatemachine_tpu_torch.physics.temperature_profiles import \
    DecayingTemperatureProfile

ps = EARTH

# the BOMEX constants
C_SMAG = 0.23
U_STAR = 0.28
T_SFC, Q_SFC = 300.4, 22.45e-3
LHF, SHF = 147.2, 9.5
DQTDT_PEAK = -1.2e-8
ZL_MOIST, ZH_MOIST = 300.0, 500.0
DTHDT_PEAK = -2.0 / 86400.0
Z_SPONGE, ALPHA_MAX, GAMMA_SP = 2400.0, 0.75, 2.0
U_GEO, U_SLOPE, V_GEO = -10.0, 1.8e-3, 0.0
ZL_SUB, ZH_SUB, W_SUB = 1500.0, 2100.0, -0.65e-2
F_CORIOLIS = 0.376e-4

#: the published case: nodal resolution (Δx, Δy, Δz) and domain [m]
RESOLUTION = (100.0, 100.0, 40.0)
DOMAIN = (6400.0, 6400.0, 3000.0)
#: the example's Courant number
COURANT = 0.35


def _z(ctx):
    return ctx.aux("orientation.Phi") / ps.grav


def _u_geo(z):
    """The sloped geostrophic wind (U_GEO + U_SLOPE z, V_GEO, 0) ``[E, 3,
    Np]``."""
    return torch.stack([U_GEO + U_SLOPE * z, torch.full_like(z, V_GEO),
                        torch.zeros_like(z)], dim=1)


@dataclass(frozen=True)
class BomexGeostrophic(Source):
    """−f ẑ × (ρu − ρ u_geo(z))."""
    z_max: float
    on_var_major_rhs = False

    def contributions_vm(self, model, ctx, t):
        m = ctx.rhou - ctx.rho[:, None] * _u_geo(_z(ctx))
        zero = torch.zeros_like(ctx.rho)
        fk = torch.stack([zero, zero, torch.full_like(zero, F_CORIOLIS)],
                         dim=1)
        return {"rhou": -torch.linalg.cross(fk, m, dim=1)}


@dataclass(frozen=True)
class BomexSponge(Source):
    """A Rayleigh sponge toward the sloped geostrophic wind above
    Z_SPONGE."""
    z_max: float
    on_var_major_rhs = False

    def contributions_vm(self, model, ctx, t):
        z = _z(ctx)
        beta = sponge_beta(z, Z_SPONGE, self.z_max, ALPHA_MAX, GAMMA_SP)
        return {"rhou": -beta[:, None]
                * (ctx.rhou - ctx.rho[:, None] * _u_geo(z))}


@dataclass(frozen=True)
class BomexTendencies(Source):
    """The large-scale moisture sink, the radiative cooling and the
    subsidence advection of h_tot and q_tot (nothing without the
    gradient flux)."""
    z_max: float
    on_var_major_rhs = False

    def contributions_vm(self, model, ctx, t):
        if ctx.gf is None:
            return {}
        rho, z, fs = ctx.rho, _z(ctx), model.gf_spec
        lin_m = (z - ZL_MOIST) / (ZH_MOIST - ZL_MOIST)
        rdqdt = rho * torch.where(
            z <= ZL_MOIST, DQTDT_PEAK,
            torch.where(z <= ZH_MOIST, DQTDT_PEAK * (1 - lin_m), 0.0))
        lin_t = (z - ZL_SUB) / (self.z_max - ZL_SUB)
        rdthdt = rho * torch.where(
            z <= ZL_SUB, DTHDT_PEAK,
            torch.where(z <= self.z_max, DTHDT_PEAK * (1 - lin_t), 0.0))
        lin_s = (z - ZL_SUB) / (ZH_SUB - ZL_SUB)
        w_s = torch.where(
            z <= ZL_SUB, z * W_SUB / ZL_SUB,
            torch.where(z <= ZH_SUB, W_SUB * (1 - lin_s), 0.0))
        cvm = td.cv_m(ps, ctx.pp)
        exn = td.exner(ps, ctx.p, ctx.pp)
        d_h = fs.get(ctx.gf, "d_h_tot")[:, 2]
        d_q = fs.get(ctx.gf, "moisture.d_q_tot")[:, 2]
        adv_q = rho * w_s * d_q
        return {"rho": rdqdt - adv_q,
                "rhoe": (cvm * rdthdt * exn + ps.e_int_v0 * rdqdt
                         - rho * w_s * d_h),
                "moisture.rhoq_tot": rdqdt - adv_q}


def init_bomex(m, coords, aux, t):
    """The BOMEX soundings: θ_liq and q_tot piecewise linear, u = −8.75
    m/s to 700 m then linear, p = p_sfc e^{−z/H}, T from (p, θ_liq,
    q_tot), the saturation-adjusted internal energy."""
    z = coords[:, 2]
    zl1, zl2, zl3, zl4 = 520.0, 1480.0, 2000.0, 3000.0
    th = torch.where(
        z <= zl1, 298.7,
        torch.where(z <= zl2, 298.7 + (z - zl1) * (302.4 - 298.7)
                    / (zl2 - zl1),
                    torch.where(z <= zl3,
                                302.4 + (z - zl2) * (308.2 - 302.4)
                                / (zl3 - zl2),
                                308.2 + (z - zl3) * (311.85 - 308.2)
                                / (zl4 - zl3))))
    qt = torch.where(
        z <= zl1, 17.0 + (z / zl1) * (16.3 - 17.0),
        torch.where(z <= zl2, 16.3 + (z - zl1) * (10.7 - 16.3) / (zl2 - zl1),
                    torch.where(z <= zl3,
                                10.7 + (z - zl2) * (4.2 - 10.7)
                                / (zl3 - zl2),
                                4.2 + (z - zl3) * (3.0 - 4.2)
                                / (zl4 - zl3)))) / 1000.0
    zlv = 700.0
    u = torch.where(z <= zlv, -8.75,
                    -8.75 + (z - zlv) * (-4.61 + 8.75) / (zl4 - zlv))

    P_sfc = 1.015e5
    Rm_sfc = td.gas_constant_air(ps, td.PhasePartition.vapor(
        torch.tensor(Q_SFC, dtype=torch.float64)))
    H = Rm_sfc.item() * T_SFC / ps.grav
    p = P_sfc * torch.exp(-z / H)
    T = td.temperature_from_theta_liq(ps, p, th, qt)
    rho = p / (td.gas_constant_air(ps, td.PhasePartition.vapor(qt)) * T)
    pp = td.phase_partition_equil(ps, T, rho, qt)
    e_int = td.internal_energy(ps, T, pp)
    Phi = m.aux_spec.get(aux, "orientation.Phi")
    return m.prog_spec.pack({
        "rho": rho, "rhoe": rho * (e_int + 0.5 * u ** 2 + Phi),
        "moisture.rhoq_tot": rho * qt,
        "rhou": torch.stack([rho * u, torch.zeros_like(u),
                             torch.zeros_like(u)], dim=1)})


def bomex_model(z_max: float = DOMAIN[2],
                surface_flux: str = "prescribed") -> AtmosModel:
    """The BOMEX AtmosModel; ``surface_flux`` "prescribed" (LHF + SHF and
    LHF/L_v(T_sfc)) or "bulk" (C_h = C_q = 0.0011 against T_sfc, q_sfc)."""
    physics = AtmosPhysics(
        ref_state=HydrostaticState(DecayingTemperatureProfile(290.0, 220.0)),
        turbulence=SmagorinskyLilly(C_SMAG), moisture=EquilMoist(maxiter=5))
    if surface_flux == "prescribed":
        energy_bc = PrescribedEnergyFlux(lambda m, q, a, t: LHF + SHF)
        moist_bc = PrescribedMoistureFlux(
            lambda m, q, a, t: LHF / td.latent_heat_vapor(ps, T_SFC))
    elif surface_flux == "bulk":
        energy_bc = BulkFormulaEnergy(C_h=lambda m, q, a, t, speed: 0.0011,
                                      T_sfc=lambda t: T_SFC)
        moist_bc = BulkFormulaMoisture(C_q=0.0011, q_tot_sfc=Q_SFC)
    else:
        raise ValueError(f"surface_flux must be 'prescribed' or 'bulk', got "
                         f"{surface_flux!r}")
    bc_bottom = AtmosBC(
        momentum=Impenetrable(DragLaw(
            lambda m, q, a, t, speed: (U_STAR / speed) ** 2)),
        energy=energy_bc, moisture=moist_bc)
    return AtmosModel(
        physics, AtmosProblem(init_state=init_bomex,
                              boundary_conditions=(bc_bottom, AtmosBC())),
        sources=(Gravity(), BomexTendencies(z_max), BomexSponge(z_max),
                 BomexGeostrophic(z_max)))


def bomex_config(resolution=RESOLUTION, domain=DOMAIN,
                 surface_flux: str = "prescribed", dtype=torch.float64,
                 device=None):
    """``AtmosLESConfiguration("bomex_les", 4, ...)`` of the BOMEX box
    (16 × 16 × 19 elements at the published defaults)."""
    return AtmosLESConfiguration(
        "bomex_les", 4, tuple(resolution), domain[0], domain[1], domain[2],
        bomex_model(domain[2], surface_flux), dtype=dtype, device=device)


def tmar_callback(dc) -> EveryXSimulationSteps:
    """TMAR on ρq_tot after every step, as an ``invoke`` callback."""
    slot = [dc.model.prog_spec.index("moisture.rhoq_tot").start]

    def apply_tmar(state):
        state.q = tmar(dc.grid, state.q, fields=slot)

    return EveryXSimulationSteps(apply_tmar, 1)


def main(argv=None):
    from climatemachine_tpu_torch.driver import driver
    from climatemachine_tpu_torch.driver.solver_configs import \
        make_solver_configuration
    ap = argparse.ArgumentParser(description="BOMEX through the driver "
                                 "entry")
    ap.add_argument("--resolution", type=float, nargs=3, default=RESOLUTION)
    ap.add_argument("--domain", type=float, nargs=3, default=DOMAIN)
    ap.add_argument("--timeend", type=float, default=1200.0)
    ap.add_argument("--surface-flux", default="prescribed",
                    choices=["prescribed", "bulk"])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    driver.init(show_updates="never")
    dc = bomex_config(args.resolution, args.domain, args.surface_flux,
                      device=args.device)
    sc = make_solver_configuration(0.0, args.timeend, dc,
                                   Courant_number=COURANT)
    print(f"dt = {sc.dt:.3f} s, elements = {dc.grid.nelem}", flush=True)
    driver.invoke(sc, user_callbacks=[tmar_callback(dc)])
    sp = dc.model.prog_spec
    rho = sp.get(sc.q, "rho")
    qt = sp.get(sc.q, "moisture.rhoq_tot") / rho
    w = sp.get(sc.q, "rhou")[:, 2] / rho
    print(f"finite: {bool(torch.isfinite(sc.q).all())}   max w: "
          f"{w.abs().max().item():.3f} m/s   q_tot range: ["
          f"{qt.min().item() * 1e3:.2f}, {qt.max().item() * 1e3:.2f}] g/kg",
          flush=True)


if __name__ == "__main__":
    main()
