"""The GCM-forced cfsite LES (the port's counterpart of
``examples/cfsite_amip.py``): a limited-area LES forced by HadGEM2-A
AMIP column profiles (``HadGEMVertical``: large-scale temperature and
moisture tendencies, ``LargeScaleProcess``; GCM subsidence,
``LargeScaleSubsidence``; a wind-relaxation sponge above 85 % of the
top, ``LinearSponge``), a u*-pinned surface drag, prescribed latent and
sensible surface fluxes, ``EquilMoist`` and ``Vreman(0.23)``; 1,800 m ×
1,800 m × 4,000 m at (75, 75, 20) m, p4, float64: 6 × 6 × 50 = 1,800
elements, at a Courant number of 0.2, with TMAR on ρq_tot after every
step.  The example's analytic site-07 sounding stands in for the GCM
columns (its NetCDF reader is not ported: the example does not use it).

Built through the driver's entry: :func:`cfsite_config` gives the
``AtmosLESConfiguration``, ``bomex_les.tmar_callback`` the callback.
CLI::

    python -m climatemachine_tpu_torch.experiments.cfsite_amip \\
        --resolution 450 450 1000 --timeend 2 --device cpu
"""

from __future__ import annotations

import argparse
import math

import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import (
    AtmosBC, DragLaw, Impenetrable, PrescribedEnergyFlux,
    PrescribedMoistureFlux)
from climatemachine_tpu_torch.atmos.lsforcing import (HadGEMVertical,
                                                      LargeScaleProcess,
                                                      LargeScaleSubsidence,
                                                      LinearSponge)
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.moisture import EquilMoist
from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
from climatemachine_tpu_torch.atmos.sources import Gravity
from climatemachine_tpu_torch.common.turbulence import Vreman
from climatemachine_tpu_torch.driver.configs import AtmosLESConfiguration
from climatemachine_tpu_torch.experiments.bomex_les import tmar_callback
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import EARTH
from climatemachine_tpu_torch.physics.temperature_profiles import \
    DecayingTemperatureProfile

ps = EARTH

#: the site's AMIP surface forcing: latent and sensible heat [W/m²] and
#: the surface temperature [K]
HFLS, HFSS, TS = 100.0, 10.0, 289.0
U_STAR = 0.28
GAMMA = 6.0e-3                # the tropospheric lapse rate [K/m]
T_SFC = 287.0
RESOLUTION = (75.0, 75.0, 20.0)
DOMAIN = (1800.0, 1800.0, 4000.0)
COURANT = 0.2


def hadgem_like_profile(z):
    """The analytic stand-in for the site-07 HadGEM2-A column (CMIP
    names; w_s already in m/s, positive up)."""
    return dict(ta=T_SFC - GAMMA * z, hus=0.0088 * torch.exp(-z / 1800.0),
                ua=torch.full_like(z, -5.0), va=torch.full_like(z, -2.0),
                temp_tendency=torch.full_like(z, -1.7e-5),
                qt_tendency=torch.full_like(z, -4.0e-9),
                w_s=-4.5e-3 * torch.clamp(z / 2000.0, 0.0, 1.0))


def _init(m, coords, aux, t):
    """The state of the closed-form sounding (the pressure hydrostatic
    at the constant lapse rate), with a deterministic 0.2 % seed mode
    below 400 m on ρe and ρq_tot."""
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    prof = hadgem_like_profile(z)
    ta, hus = prof["ta"], prof["hus"]
    pfull = ps.MSLP * (ta / T_SFC) ** (ps.grav / (ps.R_d * GAMMA))
    zero = torch.zeros_like(hus)
    pp = td.PhasePartition(hus, zero, zero)
    rho = pfull / (td.gas_constant_air(ps, pp) * ta)
    ua, va = prof["ua"], prof["va"]
    e_kin = 0.5 * (ua ** 2 + va ** 2)
    rhoe = rho * (td.internal_energy(ps, ta, pp) + e_kin + ps.grav * z)
    bump = torch.where(
        z <= 400.0,
        2e-3 * torch.sin(math.pi * x / 300.0) * torch.sin(math.pi * y / 300.0)
        * torch.sin(math.pi * z / 400.0), 0.0)
    return m.prog_spec.pack({
        "rho": rho, "rhoe": rhoe * (1.0 + bump),
        "rhou": rho[:, None] * torch.stack([ua, va, zero], dim=1),
        "moisture.rhoq_tot": rho * hus * (1.0 + bump)})


def cfsite_model(zmax: float = DOMAIN[2]) -> AtmosModel:
    physics = AtmosPhysics(
        ref_state=HydrostaticState(DecayingTemperatureProfile(T_SFC, 220.0)),
        turbulence=Vreman(0.23), moisture=EquilMoist(),
        lsforcing=HadGEMVertical(hadgem_like_profile))
    bc_bottom = AtmosBC(
        momentum=Impenetrable(DragLaw(
            lambda m, q, aux, t, norm_u: (U_STAR / norm_u) ** 2)),
        energy=PrescribedEnergyFlux(HFLS + HFSS),
        moisture=PrescribedMoistureFlux(
            lambda m, q, aux, t: HFLS / td.latent_heat_vapor(ps, TS)))
    return AtmosModel(
        physics, AtmosProblem(init_state=_init,
                              boundary_conditions=(bc_bottom, AtmosBC())),
        sources=(Gravity(),
                 LinearSponge(z_max=zmax, z_sponge=zmax * 0.85,
                              alpha_max=1.0, gamma=4.0),
                 LargeScaleProcess(), LargeScaleSubsidence()))


def cfsite_config(resolution=RESOLUTION, domain=DOMAIN, device=None):
    """``AtmosLESConfiguration("cfsite_amip", 4, ...)`` in float64 (6 ×
    6 × 50 elements at the example's defaults)."""
    return AtmosLESConfiguration(
        "cfsite_amip", 4, tuple(resolution), *domain,
        cfsite_model(domain[2]), dtype=torch.float64, device=device)


def main(argv=None):
    from climatemachine_tpu_torch.driver import driver
    from climatemachine_tpu_torch.driver.solver_configs import \
        make_solver_configuration
    ap = argparse.ArgumentParser(description="the cfsite AMIP LES")
    ap.add_argument("--resolution", type=float, nargs=3, default=RESOLUTION)
    ap.add_argument("--domain", type=float, nargs=3, default=DOMAIN)
    ap.add_argument("--timeend", type=float, default=600.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    driver.init(show_updates="never")
    dc = cfsite_config(args.resolution, args.domain, args.device)
    sc = make_solver_configuration(0.0, args.timeend, dc,
                                   Courant_number=COURANT)
    print(f"dt = {sc.dt:.3f} s, elements = {dc.grid.nelem}", flush=True)
    driver.invoke(sc, user_callbacks=[tmar_callback(dc)])
    sp = dc.model.prog_spec
    rho = sp.get(sc.q, "rho")
    qt = sp.get(sc.q, "moisture.rhoq_tot") / rho
    w = sp.get(sc.q, "rhou")[:, 2] / rho
    print(f"max|w| = {w.abs().max().item():.4f} m/s  q_tot in ["
          f"{qt.min().item() * 1e3:.3f}, {qt.max().item() * 1e3:.3f}] g/kg"
          f"  finite: {bool(torch.isfinite(sc.q).all())}", flush=True)


if __name__ == "__main__":
    main()
