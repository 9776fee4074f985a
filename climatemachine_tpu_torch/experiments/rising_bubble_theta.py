"""The rising bubble in the ρθ formulation (the port's counterpart of
``examples/rising_bubble_theta.py``): a +2 K θ bubble of radius 2000 m
at (x, z) = (L/2, 2000) m in a neutral 300 K atmosphere (hydrostatic on
θ itself), prognostic ρθ (``ThetaModel``) in the lane ``rhoe``,
``SmagorinskyLilly(0)`` (the gradient pass, no viscosity), Gravity, a
2500 m cube at 50 m, p4, float64: 12 × 12 × 12 = 1,728 elements, at a
Courant number of 0.4.  Under pure advection the θ equation has no
pressure work, so both the mass and ∫ρθ are conserved to round-off.

Built through the driver's entry: :func:`theta_bubble_config` gives the
``AtmosLESConfiguration``.  CLI (a few steps on the CPU)::

    python -m climatemachine_tpu_torch.experiments.rising_bubble_theta \\
        --resolution 312.5 312.5 312.5 --timeend 2 --device cpu
"""

from __future__ import annotations

import argparse

import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import AtmosBC
from climatemachine_tpu_torch.atmos.energy import ThetaModel
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
from climatemachine_tpu_torch.atmos.sources import Gravity
from climatemachine_tpu_torch.common.turbulence import SmagorinskyLilly
from climatemachine_tpu_torch.dg.reductions import weightedsum
from climatemachine_tpu_torch.driver.configs import AtmosLESConfiguration
from climatemachine_tpu_torch.physics.parameters import EARTH
from climatemachine_tpu_torch.physics.temperature_profiles import \
    DryAdiabaticProfile

ps = EARTH

#: the example's nodal resolution and domain [m]
RESOLUTION = (50.0, 50.0, 50.0)
DOMAIN = (2500.0, 2500.0, 2500.0)
COURANT = 0.4
#: the bubble's centre height, radius [m] and θ excess [K]
ZC, RC, AMP = 2000.0, 2000.0, 2.0


def theta_bubble_model(domain=DOMAIN) -> AtmosModel:
    """The bubble's AtmosModel (its centre at x = domain[0]/2)."""
    xc = domain[0] / 2
    physics = AtmosPhysics(
        ref_state=HydrostaticState(DryAdiabaticProfile(300.0, 0.0)),
        energy=ThetaModel(), turbulence=SmagorinskyLilly(0.0))

    def init(m, coords, aux, t):
        x, z = coords[:, 0], coords[:, 2]
        r = torch.sqrt((x - xc) ** 2 + (z - ZC) ** 2)
        theta = 300.0 + torch.where(r <= RC, AMP * (1.0 - r / RC), 0.0)
        exner = 1.0 - ps.grav / (ps.cp_d * theta) * z
        rho = ps.MSLP / (ps.R_d * theta) * exner ** (ps.cv_d / ps.R_d)
        return m.prog_spec.pack({"rho": rho, "rhoe": rho * theta})

    return AtmosModel(physics, AtmosProblem(
        init_state=init, boundary_conditions=(AtmosBC(), AtmosBC())),
        sources=(Gravity(),))


def theta_bubble_config(resolution=RESOLUTION, domain=DOMAIN, device=None):
    """``AtmosLESConfiguration("rising_bubble_theta", 4, ...)`` in
    float64 (12 × 12 × 12 elements at the example's defaults)."""
    return AtmosLESConfiguration(
        "rising_bubble_theta", 4, tuple(resolution), *domain,
        theta_bubble_model(domain), dtype=torch.float64, device=device)


def main(argv=None):
    from climatemachine_tpu_torch.driver import driver
    from climatemachine_tpu_torch.driver.solver_configs import \
        make_solver_configuration
    ap = argparse.ArgumentParser(description="the ρθ rising bubble")
    ap.add_argument("--resolution", type=float, nargs=3, default=RESOLUTION)
    ap.add_argument("--domain", type=float, nargs=3, default=DOMAIN)
    ap.add_argument("--timeend", type=float, default=100.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    driver.init(show_updates="never")
    dc = theta_bubble_config(args.resolution, args.domain, args.device)
    sc = make_solver_configuration(0.0, args.timeend, dc,
                                   Courant_number=COURANT)
    print(f"dt = {sc.dt:.3f} s, elements = {dc.grid.nelem}", flush=True)
    m0, th0 = (weightedsum(dc.grid, sc.q, i).item() for i in (0, 4))
    driver.invoke(sc)
    m1, th1 = (weightedsum(dc.grid, sc.q, i).item() for i in (0, 4))
    sp = dc.model.prog_spec
    w = sp.get(sc.q, "rhou")[:, 2] / sp.get(sc.q, "rho")
    print(f"max w: {w.max().item():.4f} m/s   mass drift: "
          f"{(m1 - m0) / m0:.2e}   rho-theta drift: {(th1 - th0) / th0:.2e}"
          f"   finite: {bool(torch.isfinite(sc.q).all())}", flush=True)


if __name__ == "__main__":
    main()
