"""DYCOMS-II RF01, the nocturnal stratocumulus LES of Stevens et al.
(2005) (the port's counterpart of ``examples/dycoms.py`` :39-111): an
840 × 840 × 1500 m box at (35, 35, 20) m, p4 and float64 (6 × 6 × 19
elements), a two-layer liquid-water potential temperature and total
water with the inversion at z_i = 840 m (saturated below it: the
stratocumulus deck), the geostrophic wind (7, −5.5) m/s,
SmagorinskyLilly(0.21), equilibrium moisture, the DYCOMS longwave
radiation, large-scale subsidence, a Rayleigh sponge above 1125 m, and
prescribed surface latent and sensible heat fluxes.

Built through the driver's entry: :func:`dycoms_config` gives the
``AtmosLESConfiguration``.  CLI::

    python -m climatemachine_tpu_torch.experiments.dycoms \\
        --resolution 105 105 187.5 --timeend 0.2 --device cpu \\
        [--diagnostics-every N --out PREFIX --writer netcdf|npz]

With ``--diagnostics-every N`` the AtmosLESDefault profiles are written
every N steps to ``PREFIX_profiles.nc`` (NetCDF-4, which needs h5py) or,
with ``--writer npz``, to ``PREFIX_profiles.npz`` and one
``PREFIX_profiles_t<time>.npz`` a write.
"""

from __future__ import annotations

import argparse

import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import (
    AtmosBC, DragLaw, Impenetrable, PrescribedEnergyFlux,
    PrescribedMoistureFlux)
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.moisture import EquilMoist
from climatemachine_tpu_torch.atmos.radiation import DYCOMSRadiationModel
from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
from climatemachine_tpu_torch.atmos.sources import (GeostrophicForcing,
                                                    Gravity, RayleighSponge,
                                                    Subsidence)
from climatemachine_tpu_torch.common.turbulence import SmagorinskyLilly
from climatemachine_tpu_torch.diagnostics.atmos_les import \
    AtmosLESDefaultGroup
from climatemachine_tpu_torch.driver.configs import AtmosLESConfiguration
from climatemachine_tpu_torch.io.writers import NetCDFWriter, NpzWriter
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import EARTH
from climatemachine_tpu_torch.physics.temperature_profiles import \
    DecayingTemperatureProfile

ps = EARTH
Z_I = 840.0
LHF, SHF = 115.0, 15.0            # W/m²
C_DRAG = 0.0011
D_SUB = 3.75e-6
U_GEO, V_GEO = 7.0, -5.5
F_COR = 7.62e-5
#: the example's nodal resolution and its fixed domain [m]
RESOLUTION = (35.0, 35.0, 20.0)
DOMAIN = (840.0, 840.0, 1500.0)
#: the example's Courant number
COURANT = 0.3


def init_dycoms(m, coords, aux, t):
    """θ_liq = 289 K and q_tot = 9 g/kg up to z_i, then 297.5 + ∛(z − z_i)
    K and 1.5 g/kg; T from (p_ref, θ_liq, q_tot); ρ = p_ref/(R_m T); the
    geostrophic wind; e_int of the all-vapour partition."""
    s = m.aux_spec
    pr = s.get(aux, "ref_state.p")
    Phi = s.get(aux, "orientation.Phi")
    z = coords[:, 2]
    below = z <= Z_I
    # ∛ as a power: the argument is ≥ 0 (torch has no cbrt)
    theta_liq = torch.where(below, 289.0,
                            297.5 + torch.clamp_min(z - Z_I, 0.0)
                            ** (1.0 / 3.0))
    q_tot = torch.where(below, torch.full_like(z, 9.0e-3), 1.5e-3)
    T = td.temperature_from_theta_liq(ps, pr, theta_liq, q_tot)
    pphase = td.PhasePartition.vapor(q_tot)
    rho = pr / (td.gas_constant_air(ps, pphase) * T)
    u = torch.stack([torch.full_like(z, U_GEO), torch.full_like(z, V_GEO),
                     torch.zeros_like(z)], dim=1)
    ke = 0.5 * torch.sum(u * u, dim=1)
    return m.prog_spec.pack({
        "rho": rho, "rhoe": rho * (td.internal_energy(ps, T, pphase) + ke
                                   + Phi),
        "rhou": rho[:, None] * u, "moisture.rhoq_tot": rho * q_tot})


def dycoms_model() -> AtmosModel:
    """The DYCOMS-II RF01 AtmosModel."""
    rad = DYCOMSRadiationModel(kappa=85.0, alpha_z=1.0, z_i=Z_I, rho_i=1.13,
                               D_subsidence=D_SUB, F_0=70.0, F_1=22.0)
    physics = AtmosPhysics(
        ref_state=HydrostaticState(DecayingTemperatureProfile(289.0, 220.0)),
        turbulence=SmagorinskyLilly(0.21), moisture=EquilMoist(),
        radiation=rad)
    bc_bottom = AtmosBC(
        momentum=Impenetrable(DragLaw(C_DRAG)),
        energy=PrescribedEnergyFlux(LHF + SHF),
        moisture=PrescribedMoistureFlux(
            lambda m, q, aux, t: LHF / ps.LH_v0))
    return AtmosModel(
        physics, AtmosProblem(init_state=init_dycoms,
                              boundary_conditions=(bc_bottom, AtmosBC())),
        sources=(Gravity(), GeostrophicForcing(F_COR, U_GEO, V_GEO),
                 Subsidence(D_SUB),
                 RayleighSponge(z_max=1500.0, z_sponge=1125.0,
                                alpha_max=1.0,
                                u_relaxation=(U_GEO, V_GEO, 0.0))))


def dycoms_config(resolution=RESOLUTION, device=None):
    """``AtmosLESConfiguration("dycoms", 4, ...)`` of the fixed 840 × 840
    × 1500 m box (6 × 6 × 19 elements at the example's resolution)."""
    return AtmosLESConfiguration("dycoms", 4, tuple(resolution), *DOMAIN,
                                 dycoms_model(), dtype=torch.float64,
                                 device=device)


def main(argv=None):
    from climatemachine_tpu_torch.driver import driver
    from climatemachine_tpu_torch.driver.solver_configs import \
        make_solver_configuration
    ap = argparse.ArgumentParser(description="DYCOMS-II RF01 through the "
                                 "driver entry")
    ap.add_argument("--resolution", type=float, nargs=3, default=RESOLUTION)
    ap.add_argument("--timeend", type=float, default=60.0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--diagnostics-every", type=int, default=0,
                    help="write the AtmosLESDefault profiles every N steps")
    ap.add_argument("--out", default="dycoms",
                    help="the profiles' path prefix")
    ap.add_argument("--writer", choices=("netcdf", "npz"), default="netcdf")
    args = ap.parse_args(argv)
    driver.init(show_updates="never")
    dc = dycoms_config(args.resolution, device=args.device)
    sc = make_solver_configuration(0.0, args.timeend, dc,
                                   Courant_number=COURANT)
    print(f"dt = {sc.dt:.3f} s, elements = {dc.grid.nelem}", flush=True)
    cbs = []
    if args.diagnostics_every:
        writer, ext = ((NetCDFWriter(), "nc") if args.writer == "netcdf"
                       else (NpzWriter(), "npz"))
        path = f"{args.out}_profiles.{ext}"
        grp = AtmosLESDefaultGroup(sc.dg, writer=writer, out_path=path)
        cbs.append(grp.make_callback(args.diagnostics_every))
        print(f"AtmosLESDefault profiles -> {path}", flush=True)
    driver.invoke(sc, user_callbacks=cbs)
    model = dc.model
    qliq = model.aux_spec.get(sc.aux, "moisture.q_liq")
    w = model.prog_spec.get(sc.q, "rhou")[:, 2] / model.prog_spec.get(
        sc.q, "rho")
    print(f"max q_liq: {qliq.max().item() * 1e3:.3f} g/kg   "
          f"max |w|: {w.abs().max().item():.3f} m/s", flush=True)


if __name__ == "__main__":
    main()
