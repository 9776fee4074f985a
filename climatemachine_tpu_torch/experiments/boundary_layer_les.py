"""The dry boundary-layer LES (the port's counterparts of
``examples/convective_bl_les.py`` and ``examples/stable_bl_les.py``).

Convective: θ = 288 K + 4 K/km on a hydrostatic Exner profile built on θ
itself, SmagorinskyLilly(0.23), a bulk surface energy flux (C_h =
C_d = 0.001) against the diurnally heated surface θ_sfc = 291.15 + 20
sin(πt/12 h), geostrophic relaxation to 4 m/s and a Rayleigh sponge
above 2560 m; 4800 × 4800 × 3200 m at (80, 80, 40) m, p4: 15 × 15 × 20
= 4,500 elements.

Stable (GABLS, 73° N): θ = 265 K to 100 m then +0.01 K/m, u = 8 m/s, a
u*-pinned drag (u* = 0.3 m/s), the surface cooling at 0.25 K/h through
a bulk energy flux ("bulk") or a prescribed surface temperature
("custom_sbl"), ConstantKinematicViscosity(0), geostrophic relaxation
and a sponge above 300 m; 100 × 100 × 400 m at (20, 20, 10) m: 1 × 1 ×
10 elements.

Both float64 and built through the driver's entry
(``AtmosLESConfiguration``).  Their sources leave ρ alone, so the mass
is conserved to round-off.  CLI::

    python -m climatemachine_tpu_torch.experiments.boundary_layer_les \\
        --case stable --timeend 0.5 --device cpu
"""

from __future__ import annotations

import argparse
import math

import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import (
    AtmosBC, BulkFormulaEnergy, DragLaw, Impenetrable, PrescribedTemperature)
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
from climatemachine_tpu_torch.atmos.sources import (GeostrophicForcing,
                                                    Gravity, RayleighSponge)
from climatemachine_tpu_torch.common.turbulence import (
    ConstantKinematicViscosity, SmagorinskyLilly)
from climatemachine_tpu_torch.driver.configs import AtmosLESConfiguration
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import EARTH
from climatemachine_tpu_torch.physics.temperature_profiles import \
    DecayingTemperatureProfile

ps = EARTH
#: nodal resolution and domain [m] of each case's example defaults
CBL_RESOLUTION, CBL_DOMAIN = (80.0, 80.0, 40.0), (4800.0, 4800.0, 3200.0)
SBL_RESOLUTION, SBL_DOMAIN = (20.0, 20.0, 10.0), (100.0, 100.0, 400.0)
#: the Courant numbers of both examples
COURANT = 0.4


def _ref_state():
    return HydrostaticState(DecayingTemperatureProfile(290.0, 220.0))


def convective_bl_model(z_max: float = CBL_DOMAIN[2]) -> AtmosModel:
    """The convective boundary layer's AtmosModel."""
    C_drag, u_geo, v_geo, f_cor = 0.001, 4.0, 0.0, 1.031e-4

    def init(m, coords, aux, t):
        z = coords[:, 2]
        theta = 288.0 + 4.0e-3 * z
        exner = 1.0 - ps.grav / (ps.cp_d * theta) * z
        rho = ps.MSLP / (ps.R_d * theta) * exner ** (ps.cv_d / ps.R_d)
        T = theta * exner
        Phi = m.aux_spec.get(aux, "orientation.Phi")
        return m.prog_spec.pack(
            {"rho": rho, "rhoe": rho * (td.internal_energy(ps, T) + Phi)})

    def surface_T(model, q, aux, t):
        """θ_sfc(t) → T at the local surface density (ρ, θ) state."""
        theta_sfc = 291.15 + 20.0 * math.sin(math.pi * t / (12 * 3600.0))
        rho = model.prog_spec.get(q, "rho")
        return theta_sfc * (rho * ps.R_d * theta_sfc / ps.MSLP) \
            ** (ps.R_d / ps.cv_d)

    bc_bottom = AtmosBC(
        momentum=Impenetrable(DragLaw(C_drag)),
        energy=BulkFormulaEnergy(C_h=lambda model, q, aux, t, speed: C_drag,
                                 T_sfc=surface_T))
    return AtmosModel(
        AtmosPhysics(ref_state=_ref_state(),
                     turbulence=SmagorinskyLilly(0.23)),
        AtmosProblem(init_state=init,
                     boundary_conditions=(bc_bottom, AtmosBC())),
        sources=(Gravity(), GeostrophicForcing(f_cor, u_geo, v_geo),
                 RayleighSponge(z_max=z_max, z_sponge=2560.0,
                                alpha_max=0.75,
                                u_relaxation=(u_geo, v_geo, 0.0))))


def surface_temperature(t):
    """The stable case's surface: 265 K cooling at 0.25 K/h."""
    return 265.0 - 0.25 * (t / 3600.0)


def stable_bl_model(z_max: float = SBL_DOMAIN[2],
                    surface_flux: str = "bulk") -> AtmosModel:
    """The GABLS stable boundary layer's AtmosModel; ``surface_flux``
    "bulk" or "custom_sbl" (the prescribed surface temperature)."""
    u_star, C_drag, u_geo, v_geo, f_cor = 0.30, 0.0044, 8.0, 0.0, 1.39e-4

    def init(m, coords, aux, t):
        z = coords[:, 2]
        theta = torch.where(z <= 100.0, 265.0,
                            265.0 + 0.01 * torch.clamp_min(z - 100.0, 0.0))
        pr = m.aux_spec.get(aux, "ref_state.p")
        Phi = m.aux_spec.get(aux, "orientation.Phi")
        T = theta * (pr / ps.MSLP) ** ps.kappa_d
        rho = pr / (ps.R_d * T)
        u = torch.stack([torch.full_like(z, u_geo), torch.zeros_like(z),
                         torch.zeros_like(z)], dim=1)
        ke = 0.5 * torch.sum(u * u, dim=1)
        return m.prog_spec.pack({
            "rho": rho, "rhoe": rho * (td.internal_energy(ps, T) + ke + Phi),
            "rhou": rho[:, None] * u})

    def drag_coef(model, q, aux, t, speed):
        """C_d = (u*/|u_t|)²."""
        return (u_star / torch.clamp_min(speed, 1e-4)) ** 2

    if surface_flux == "bulk":
        energy_bc = BulkFormulaEnergy(
            C_h=lambda model, q, aux, t, speed: C_drag,
            T_sfc=lambda t: surface_temperature(t))
    elif surface_flux == "custom_sbl":
        energy_bc = PrescribedTemperature(
            T_sfc=lambda t: surface_temperature(t))
    else:
        raise ValueError("surface_flux must be 'bulk' or 'custom_sbl', got "
                         f"{surface_flux!r}")
    bc_bottom = AtmosBC(momentum=Impenetrable(DragLaw(drag_coef)),
                        energy=energy_bc)
    return AtmosModel(
        AtmosPhysics(ref_state=_ref_state(),
                     turbulence=ConstantKinematicViscosity(0.0)),
        AtmosProblem(init_state=init,
                     boundary_conditions=(bc_bottom, AtmosBC())),
        sources=(Gravity(), GeostrophicForcing(f_cor, u_geo, v_geo),
                 RayleighSponge(z_max=z_max, z_sponge=300.0, alpha_max=0.75,
                                u_relaxation=(u_geo, v_geo, 0.0))))


def convective_bl_config(resolution=CBL_RESOLUTION, domain=CBL_DOMAIN,
                         device=None):
    """``AtmosLESConfiguration("convective_bl", 4, ...)``."""
    return AtmosLESConfiguration(
        "convective_bl", 4, tuple(resolution), domain[0], domain[1],
        domain[2], convective_bl_model(domain[2]), dtype=torch.float64,
        device=device)


def stable_bl_config(resolution=SBL_RESOLUTION, domain=SBL_DOMAIN,
                     surface_flux: str = "bulk", device=None):
    """``AtmosLESConfiguration("stable_bl", 4, ...)``."""
    return AtmosLESConfiguration(
        "stable_bl", 4, tuple(resolution), domain[0], domain[1], domain[2],
        stable_bl_model(domain[2], surface_flux), dtype=torch.float64,
        device=device)


def main(argv=None):
    from climatemachine_tpu_torch.driver import driver
    from climatemachine_tpu_torch.driver.solver_configs import \
        make_solver_configuration
    ap = argparse.ArgumentParser(description="The dry boundary-layer LES "
                                 "through the driver entry")
    ap.add_argument("--case", default="convective",
                    choices=["convective", "stable"])
    ap.add_argument("--surface-flux", default="bulk",
                    choices=["bulk", "custom_sbl"])
    ap.add_argument("--timeend", type=float, default=360.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    driver.init(show_updates="never")
    dc = (convective_bl_config(device=args.device)
          if args.case == "convective"
          else stable_bl_config(surface_flux=args.surface_flux,
                                device=args.device))
    sc = make_solver_configuration(0.0, args.timeend, dc,
                                   Courant_number=COURANT)
    print(f"dt = {sc.dt:.3f} s, elements = {dc.grid.nelem}", flush=True)
    driver.invoke(sc)
    sp = dc.model.prog_spec
    u = sp.get(sc.q, "rhou") / sp.get(sc.q, "rho")[:, None]
    print(f"max |u|: {u.abs().max().item():.4f} m/s   finite: "
          f"{bool(torch.isfinite(sc.q).all())}", flush=True)


if __name__ == "__main__":
    main()
