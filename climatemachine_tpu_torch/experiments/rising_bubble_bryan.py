"""A rising thermal bubble stepped by multirate solvers (the port's
counterpart of ``examples/rising_bubble_bryan.py``, the reference's
experiments/AtmosLES/rising_bubble_bryan.jl).

A Bryan-style large bubble: a 20 km × 2 km × 10 km box (x, y, z; y one
element deep at the example's resolutions), a 2 K cos² θ perturbation of
radius 2 km centred at (x, z) = (10, 2) km in a hydrostatic
dry-adiabatic atmosphere (300 K at the ground, 110 K floor),
SmagorinskyLilly(0.21), Gravity, free-slip insulating walls, p4,
float64, dt at a Courant number of 0.4.  Its point is the solver menu
(``fast_method``): ``lsrk`` (MIS2 with LSRK54 fast substeps), ``ssprk``
(MIS2 with SSPRK33ShuOsher), ``mrrk`` (MultirateRungeKutta) or ``imex``
(ARK2GKC with the column solve), each with ``nsubsteps`` fast steps a
slow one.  Built through the driver's entry:
``AtmosLESConfiguration`` → ``make_solver_configuration`` → ``invoke``.
The example's smoke (10 × 1 × 5 elements)::

    python -m climatemachine_tpu_torch.experiments.rising_bubble_bryan \\
        --timeend 20 --resolution 500 [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import AtmosBC
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
from climatemachine_tpu_torch.atmos.sources import Gravity
from climatemachine_tpu_torch.common.turbulence import SmagorinskyLilly
from climatemachine_tpu_torch.driver import driver
from climatemachine_tpu_torch.driver.configs import AtmosLESConfiguration
from climatemachine_tpu_torch.driver.solver_configs import \
    make_solver_configuration
from climatemachine_tpu_torch.driver.solver_types import (IMEXSolverType,
                                                          MISSolverType,
                                                          MultirateSolverType)
from climatemachine_tpu_torch.ode.mis import MIS2
from climatemachine_tpu_torch.ode.ssprk import SSPRK33ShuOsher
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import EARTH
from climatemachine_tpu_torch.physics.temperature_profiles import \
    DryAdiabaticProfile

FAST_METHODS = ("lsrk", "ssprk", "mrrk", "imex")
DOMAIN = (20000.0, 2000.0, 10000.0)
#: the bubble's centre x, z [m], radius [m] and θ excess [K]
BUBBLE = (10000.0, 2000.0, 2000.0, 2.0)
COURANT = 0.4
RESOLUTION, TIMEEND, NSUBSTEPS = 250.0, 100.0, 12


def bryan_model() -> AtmosModel:
    ps = EARTH
    physics = AtmosPhysics(
        ref_state=HydrostaticState(DryAdiabaticProfile(300.0, 110.0)),
        turbulence=SmagorinskyLilly(0.21))

    def init(m, coords, aux, t):
        x, z = coords[:, 0], coords[:, 2]
        xc, zc, rc, amp = BUBBLE
        p = m.aux_spec.get(aux, "ref_state.p")
        r = torch.sqrt((x - xc) ** 2 + (z - zc) ** 2)
        dtheta = torch.where(r <= rc, amp * torch.cos(0.5 * math.pi * r
                                                      / rc) ** 2,
                             torch.zeros_like(r))
        T = (300.0 + dtheta) * (p / ps.MSLP) ** ps.kappa_d
        rho = p / (ps.R_d * T)
        Phi = m.aux_spec.get(aux, "orientation.Phi")
        return m.prog_spec.pack(
            {"rho": rho, "rhoe": rho * (td.internal_energy(ps, T) + Phi)})

    return AtmosModel(physics, AtmosProblem(
        init_state=init, boundary_conditions=(AtmosBC(), AtmosBC())),
        sources=(Gravity(),))


def bryan_config(resolution: float = RESOLUTION, device=None):
    """``AtmosLESConfiguration("rising_bubble_bryan", 4, (Δ, 8Δ, Δ),
    ...)`` in float64."""
    return AtmosLESConfiguration(
        "rising_bubble_bryan", 4, (resolution, resolution * 8, resolution),
        *DOMAIN, bryan_model(), dtype=torch.float64, device=device)


def solver_type(fast_method: str, nsubsteps: int = NSUBSTEPS):
    """The menu's solver type."""
    if fast_method == "lsrk":
        return MISSolverType(mis_method=MIS2, nsubsteps=nsubsteps)
    if fast_method == "ssprk":
        return MISSolverType(mis_method=MIS2, fast_method=SSPRK33ShuOsher,
                             nsubsteps=nsubsteps)
    if fast_method == "mrrk":
        return MultirateSolverType(timestep_ratio=nsubsteps)
    if fast_method == "imex":
        return IMEXSolverType()
    raise ValueError(f"fast_method must be one of {FAST_METHODS}, got "
                     f"{fast_method!r}")


def max_updraft(model, q) -> float:
    sp = model.prog_spec
    return (sp.get(q, "rhou")[:, 2] / sp.get(q, "rho")).max().item()


def run(fast_method: str = "lsrk", resolution: float = RESOLUTION,
        timeend: float = TIMEEND, nsubsteps: int = NSUBSTEPS, device=None):
    """The example to ``timeend``: returns the solver configuration (the
    final state in ``sc.q``) and the max updraft [m/s]; raises unless the
    state stays finite, as the example asserts."""
    dc = bryan_config(resolution, device)
    sc = make_solver_configuration(0.0, timeend, dc,
                                   Courant_number=COURANT,
                                   ode_solver_type=solver_type(fast_method,
                                                               nsubsteps))
    driver.invoke(sc)
    if not bool(torch.isfinite(sc.q).all()):
        raise FloatingPointError(f"rising_bubble_bryan ({fast_method}): "
                                 "the state is not finite")
    return sc, max_updraft(dc.model, sc.q)


def main(argv=None):
    ap = argparse.ArgumentParser(description="the Bryan rising bubble")
    ap.add_argument("--fast-method", choices=FAST_METHODS, default="lsrk")
    ap.add_argument("--resolution", type=float, default=RESOLUTION)
    ap.add_argument("--timeend", type=float, default=TIMEEND)
    ap.add_argument("--nsubsteps", type=int, default=NSUBSTEPS)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    driver.init(show_updates="never")
    sc, w = run(args.fast_method, args.resolution, args.timeend,
                args.nsubsteps, args.device)
    print(f"fast_method={args.fast_method} dt={sc.dt:.3f}s "
          f"elements={sc.dg.grid.nelem}", flush=True)
    print(f"max updraft velocity: {w:.3f} m/s", flush=True)


if __name__ == "__main__":
    main()
