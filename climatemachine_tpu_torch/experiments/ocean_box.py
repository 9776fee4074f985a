"""The ocean box GCM (the port's counterpart of
``examples/ocean_box_gcm.py``): HydrostaticBoussinesqModel on a closed
stacked box with c_h = √(gH), float64, explicit LSRK144 with the
model's vertical filters before each stage.

- "homogeneous": the wind-driven box with uniform θ = 20
  (HomogeneousBox); coasts no-slip, the floor no-slip (free-slip with
  ``floor_free_slip``, the windstress test's variant), the surface
  penetrable under the problem's KinematicStress.
- "gyre": the wind stress and the surface temperature restoring
  (OceanGyre, with its convective adjustment of κ).

Drive the returned solver with ``ode/solve.py`` ``solve(q0, aux0,
solver, timeend)``, as the example does.
"""

from __future__ import annotations

import math

import torch

from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.ocean.core import (FreeSlip, Impenetrable,
                                                 Insulating, KinematicStress,
                                                 NoSlip, OceanBC, Penetrable)
from climatemachine_tpu_torch.ocean.hydrostatic_boussinesq import (
    HydrostaticBoussinesqModel)
from climatemachine_tpu_torch.ocean.problems import (HomogeneousBox,
                                                     OceanGyre,
                                                     ocean_box_grid)
from climatemachine_tpu_torch.ode.lsrk import LSRK144NiegemannDiehlBusch
from climatemachine_tpu_torch.physics.parameters import EARTH

PROBLEMS = ("homogeneous", "gyre")


def ocean_box_problem(problem: str = "homogeneous",
                      domain=(4e6, 4e6, 400.0),
                      floor_free_slip: bool = False):
    """The example's problem on ``domain`` (Lx, Ly, H)."""
    if problem not in PROBLEMS:
        raise ValueError(f"problem must be one of {PROBLEMS}, got "
                         f"{problem!r}")
    Lx, Ly, H = domain
    if problem == "gyre":
        return OceanGyre(Lx, Ly, H)
    floor = FreeSlip() if floor_free_slip else NoSlip()
    return HomogeneousBox(Lx, Ly, H, boundary_conditions=(
        OceanBC(Impenetrable(NoSlip()), Insulating()),
        OceanBC(Impenetrable(floor), Insulating()),
        OceanBC(Penetrable(KinematicStress()), Insulating())))


def ocean_box_config(problem: str = "homogeneous", nelem=(20, 20, 20),
                     polyorder: int = 4, domain=(4e6, 4e6, 400.0),
                     dt: float = 55.0, floor_free_slip: bool = False,
                     dtype: torch.dtype = torch.float64, device=None):
    """(dg, q0, aux0, solver) of the example at its defaults: 20 × 20 ×
    20 elements at p4 over 4e6 × 4e6 × 400 m, dt = 55 s;
    ``device=None`` means CUDA."""
    prob = ocean_box_problem(problem, domain, floor_free_slip)
    model = HydrostaticBoussinesqModel(
        prob, c_h=math.sqrt(EARTH.grav * domain[2]))
    grid = ocean_box_grid(prob, *nelem, polyorder, dtype=dtype,
                          device=device)
    dg = DGModel(model, grid)
    q0, aux0 = init_ode_state(dg)
    solver = LSRK144NiegemannDiehlBusch(dg, dt, pre_stage=dg.pre_stage)
    return dg, q0, aux0, solver
