"""The solid-body rotation steady state through the GCM driver entry
(port of ``examples/solid_body_rotation.py``, the JAX caller of
``AtmosGCMConfiguration``, :68-74).

An atmosphere at rest in the rotating frame over a DecayingTemperature
Profile(290, 220, 8e3) hydrostatic reference state on the cubed sphere
must stay at rest: the discrete pressure gradient and the gravity source
cancel through the reference-state split and Coriolis vanishes at u = 0.
As the reference configures it: the Roe flux, HEVI IMEX (ARK2GKC with
the column solve of the acoustic-gravity linear model), dt from a
horizontal Courant number of 0.2, 30 km high; the rest state is kept
while max |u| < 0.5 m/s.

    python -m climatemachine_tpu_torch.experiments.solid_body_rotation \\
        [--n-horz 4] [--n-vert 3] [--poly 4] [--timeend 7200] \\
        [--explicit] [--device cpu]

prints dt, the norm ratio, the relative mass drift and max |u|.
"""

from __future__ import annotations

import argparse

import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import AtmosBC
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
from climatemachine_tpu_torch.atmos.sources import Coriolis, Gravity
from climatemachine_tpu_torch.common.orientations import SphericalOrientation
from climatemachine_tpu_torch.dg.numerical_fluxes import RoeNumericalFlux
from climatemachine_tpu_torch.dg.reductions import weightedsum
from climatemachine_tpu_torch.driver.configs import AtmosGCMConfiguration
from climatemachine_tpu_torch.driver.solver_configs import \
    make_solver_configuration
from climatemachine_tpu_torch.driver.solver_types import (ExplicitSolverType,
                                                          IMEXSolverType)
from climatemachine_tpu_torch.physics.parameters import EARTH
from climatemachine_tpu_torch.physics.temperature_profiles import \
    DecayingTemperatureProfile

#: the rest state holds while max |u| stays below this (m/s)
MAX_ABS_U = 0.5


def rest_state(model, coords, aux, t):
    """ρ and ρe of the reference state, ρu = 0."""
    sp = model.aux_spec
    rho = sp.get(aux, "ref_state.rho")
    rhoe = sp.get(aux, "ref_state.rhoe")
    zero = torch.zeros_like(rho)
    return torch.stack([rho, zero, zero, zero, rhoe], dim=1)


def solid_body_rotation_model(param_set=EARTH) -> AtmosModel:
    physics = AtmosPhysics(
        param_set=param_set, orientation=SphericalOrientation(),
        ref_state=HydrostaticState(
            DecayingTemperatureProfile(290.0, 220.0, 8e3)))
    return AtmosModel(physics,
                      AtmosProblem(init_state=rest_state,
                                   boundary_conditions=(AtmosBC(),
                                                        AtmosBC())),
                      sources=(Gravity(), Coriolis()))


def solid_body_rotation_config(n_horz: int = 4, n_vert: int = 3,
                               poly_order: int = 4, timeend: float = 7200.0,
                               explicit: bool = False, dtype=None,
                               device=None):
    """The solver configuration: ``AtmosGCMConfiguration`` with the Roe
    flux, ``IMEXSolverType()`` (``ExplicitSolverType()`` with
    ``explicit``), Courant 0.2 in the horizontal."""
    dc = AtmosGCMConfiguration("solid_body_rotation", poly_order,
                               (n_horz, n_vert), 30e3,
                               solid_body_rotation_model(), dtype=dtype,
                               device=device)
    dc.numerical_flux_first_order = RoeNumericalFlux()
    return make_solver_configuration(
        0.0, timeend, dc,
        ode_solver_type=ExplicitSolverType() if explicit
        else IMEXSolverType(),
        Courant_number=0.2, CFL_direction="horizontal")


def rest_summary(sc, q0, q) -> dict:
    """The relative mass drift and max |u| of q against q0."""
    g = sc.dg.grid
    m0, m1 = float(weightedsum(g, q0, 0)), float(weightedsum(g, q, 0))
    umax = torch.linalg.vector_norm(q[:, 1:4] / q[:, :1], dim=1).max()
    return dict(mass_drift_rel=abs(m1 - m0) / abs(m0),
                max_abs_u=float(umax), finite=bool(torch.isfinite(q).all()))


def main(argv=None):
    from climatemachine_tpu_torch.driver import driver
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-horz", type=int, default=4)
    ap.add_argument("--n-vert", type=int, default=3)
    ap.add_argument("--poly", type=int, default=4)
    ap.add_argument("--timeend", type=float, default=7200.0)
    ap.add_argument("--explicit", action="store_true")
    ap.add_argument("--device", default=None)
    args, _ = ap.parse_known_args(argv)
    driver.init(parse_clargs=True, argv=argv)
    dtype = torch.float64 if args.device == "cpu" else torch.float32
    sc = solid_body_rotation_config(args.n_horz, args.n_vert, args.poly,
                                    args.timeend, args.explicit, dtype,
                                    args.device)
    q0 = sc.q
    print(f"dt = {sc.dt:.2f} s, elements = {sc.dg.grid.nelem}, solver = "
          f"{'explicit' if args.explicit else 'IMEX ARK2'}", flush=True)
    ratio = driver.invoke(sc)
    s = rest_summary(sc, q0, sc.q)
    print(f"norm(Q)/norm(Q0) = {ratio:.8f}   mass rel drift = "
          f"{s['mass_drift_rel']:.2e}   max |u| (spurious) = "
          f"{s['max_abs_u']:.3e} m/s", flush=True)
    if not (s["finite"] and s["max_abs_u"] < MAX_ABS_U):
        raise SystemExit("rest state not maintained")


if __name__ == "__main__":
    main()
