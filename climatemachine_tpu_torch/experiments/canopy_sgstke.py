"""The canopy LES with the prognostic SGS TKE (the port's counterpart of
``examples/canopy_sgstke.py``, after Patton et al. 2016): a 100 m cube
at (10, 10, 5) m, p4 and float64 (2 × 2 × 5 elements), a 20 m canopy
(c_d = 0.2, LAI = 2) whose form drag slows the wind and destroys SGS
TKE, transpires against the vapour-pressure deficit (G_veg = 0.2) and
takes up a CO₂ tracer (GPP = 1); the Deardorff closure with the
``SGStkeModel``, dry or equilibrium moisture, surface drag C_d = 0.0011,
prescribed surface heat (LHF + SHF) and moisture (LHF / L_v) fluxes, θ
= 300 K to 2 h_c then −3 K/km, a 5 m/s wind, e_SGS = 0.2 e_kin, CO₂ 340
ppm; LSRK144 at Courant 0.1.

Built through the driver's entry: :func:`canopy_config` gives the
``AtmosLESConfiguration``, :data:`SOLVER_TYPE` the solver type.  CLI::

    python -m climatemachine_tpu_torch.experiments.canopy_sgstke \\
        --resolution 25 25 25 --timeend 0.005 --device cpu
"""

from __future__ import annotations

import argparse

import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import (
    AtmosBC, DragLaw, Impenetrable, PrescribedEnergyFlux,
    PrescribedMoistureFlux)
from climatemachine_tpu_torch.atmos.canopy import (CanopyAerodynamics,
                                                   CanopyAtmoInteraction)
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.moisture import DryModel, EquilMoist
from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
from climatemachine_tpu_torch.atmos.sgstke import SGStkeModel
from climatemachine_tpu_torch.atmos.sources import Gravity
from climatemachine_tpu_torch.atmos.tracers import NTracers
from climatemachine_tpu_torch.common.turbulence import Deardorff
from climatemachine_tpu_torch.driver.configs import AtmosLESConfiguration
from climatemachine_tpu_torch.driver.solver_types import ExplicitSolverType
from climatemachine_tpu_torch.ode.lsrk import LSRK144NiegemannDiehlBusch
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import EARTH
from climatemachine_tpu_torch.physics.temperature_profiles import \
    DryAdiabaticProfile

ps = EARTH
C_D, LAI, H_C = 0.2, 2.0, 20.0
G_VEG, GPP = 0.2, 1.0
C_DRAG = 0.0011
LHF, SHF = 50.0, 15.0
U_GEO = 5.0
Q_TOT0 = 1e-3
RESOLUTION = (10.0, 10.0, 5.0)
DOMAIN = (100.0, 100.0, 100.0)
COURANT = 0.1
#: the example's solver type
SOLVER_TYPE = ExplicitSolverType(solver_method=LSRK144NiegemannDiehlBusch)


def canopy_model(moisture: str = "equilibrium",
                 dz: float = RESOLUTION[2]) -> AtmosModel:
    """The canopy AtmosModel; ``moisture`` "dry" or "equilibrium"."""
    if moisture not in ("dry", "equilibrium"):
        raise ValueError("moisture must be 'dry' or 'equilibrium', got "
                         f"{moisture!r}")
    dry = moisture == "dry"
    physics = AtmosPhysics(
        ref_state=HydrostaticState(DryAdiabaticProfile(300.0, 0.0)),
        turbulence=Deardorff(),
        moisture=DryModel() if dry else EquilMoist(maxiter=5),
        tracers=NTracers((1.6e-5,)), sgstke=SGStkeModel())

    def init(m, coords, aux, t):
        z = coords[:, 2]
        theta = torch.where(z <= 2 * H_C, 300.0,
                            300.0 - 3e-3 * (z - 2 * H_C))
        Phi = m.aux_spec.get(aux, "orientation.Phi")
        if dry:
            exner = 1.0 - ps.grav / (ps.cp_d * theta) * z
            rho = ps.MSLP / (ps.R_d * theta) * exner ** (ps.cv_d / ps.R_d)
            e_int = td.internal_energy(ps, theta * exner)
        else:
            pp = td.PhasePartition.vapor(torch.full_like(z, Q_TOT0))
            Rm = td.gas_constant_air(ps, pp)
            pz = ps.MSLP * torch.exp(-z / (Rm * 300.0 / ps.grav))
            T = theta * (pz / ps.MSLP) ** ps.kappa_d
            rho = pz / (Rm * T)
            e_int = td.internal_energy(ps, T, pp)
        e_kin = 0.5 * U_GEO ** 2
        fields = {"rho": rho, "rhoe": rho * (e_int + e_kin + Phi),
                  "sgstke.rhoe_SGS": rho * 0.2 * e_kin,
                  "tracers.rhochi": (3.4e-4 * rho)[:, None],
                  "rhou": torch.stack([rho * U_GEO, torch.zeros_like(rho),
                                       torch.zeros_like(rho)], dim=1)}
        if not dry:
            fields["moisture.rhoq_tot"] = rho * Q_TOT0
        return m.prog_spec.pack(fields)

    moisture_bc = {} if dry else {"moisture": PrescribedMoistureFlux(
        lambda model, q, aux, t: LHF / ps.LH_v0)}
    bc_bottom = AtmosBC(momentum=Impenetrable(DragLaw(C_DRAG)),
                        energy=PrescribedEnergyFlux(
                            lambda model, q, aux, t: LHF + SHF),
                        **moisture_bc)
    return AtmosModel(
        physics, AtmosProblem(init_state=init,
                              boundary_conditions=(bc_bottom, AtmosBC())),
        sources=(Gravity(), CanopyAerodynamics(C_D, H_C, LAI, dz),
                 CanopyAtmoInteraction(H_C, LAI, dz, G_VEG, GPP)))


def canopy_config(resolution=RESOLUTION, domain=DOMAIN,
                  moisture: str = "equilibrium", device=None):
    """``AtmosLESConfiguration("canopy_sgstke", 4, ...)``."""
    return AtmosLESConfiguration(
        "canopy_sgstke", 4, tuple(resolution), domain[0], domain[1],
        domain[2], canopy_model(moisture, resolution[2]),
        dtype=torch.float64, device=device)


def main(argv=None):
    from climatemachine_tpu_torch.driver import driver
    from climatemachine_tpu_torch.driver.solver_configs import \
        make_solver_configuration
    ap = argparse.ArgumentParser(description="The canopy LES with SGS TKE "
                                 "through the driver entry")
    ap.add_argument("--resolution", type=float, nargs=3, default=RESOLUTION)
    ap.add_argument("--domain", type=float, nargs=3, default=DOMAIN)
    ap.add_argument("--timeend", type=float, default=600.0)
    ap.add_argument("--moisture", default="equilibrium",
                    choices=["dry", "equilibrium"])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    driver.init(show_updates="never")
    dc = canopy_config(args.resolution, args.domain, args.moisture,
                       device=args.device)
    sc = make_solver_configuration(0.0, args.timeend, dc,
                                   ode_solver_type=SOLVER_TYPE,
                                   Courant_number=COURANT)
    print(f"dt = {sc.dt:.4f} s, elements = {dc.grid.nelem}", flush=True)
    driver.invoke(sc)
    sp = dc.model.prog_spec
    rho = sp.get(sc.q, "rho")
    e_sgs = sp.get(sc.q, "sgstke.rhoe_SGS") / rho
    chi = sp.get(sc.q, "tracers.rhochi")[:, 0] / rho
    print(f"finite: {bool(torch.isfinite(sc.q).all())}   max e_SGS: "
          f"{e_sgs.max().item():.4f} m²/s²   min CO₂: "
          f"{chi.min().item() * 1e6:.2f} ppm", flush=True)


if __name__ == "__main__":
    main()
