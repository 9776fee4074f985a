"""Solver configuration (port of
``climatemachine_tpu/driver/solver_configs.py`` :24-100:
``SolverConfiguration`` and ``make_solver_configuration``).

``make_solver_configuration`` builds the configuration's DG operator
with its numerical fluxes, the initial state, dt from the Courant number
(``calculate_dt`` with the non-diffusive Courant number) or as given,
snapped so that whole steps land on ``timeend``, and the solver of the
solver type (``ExplicitSolverType()`` by default: "auto" puts a model
with a turbulence closure on the generic DG operator and an inviscid
one that the var-major RHS takes on that RHS).  ``restart_from=
(directory, num)`` takes q, aux and t0 from that checkpoint
(driver/checkpoint.py; a file the JAX package wrote too), on the
configuration's device in its grid's dtype, in place of the initial
state; dt then comes from the restored state.  With the driver's
``debug_init`` setting it writes the initial state's VTK dump
``<output_dir>/<name>_init.vtu`` and logs the state's and the aux's
non-finite lanes.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

from climatemachine_tpu_torch.dg.courant import (calculate_dt,
                                                 nondiffusive_courant)
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.driver.configs import DriverConfiguration
from climatemachine_tpu_torch.driver.callbacks import show_not_finite_fields
from climatemachine_tpu_torch.driver.checkpoint import read_checkpoint
from climatemachine_tpu_torch.driver.driver import SETTINGS
from climatemachine_tpu_torch.driver.solver_types import ExplicitSolverType
from climatemachine_tpu_torch.interop import state_from_numpy
from climatemachine_tpu_torch.io.vtk import vtk_dump_state


@dataclass
class SolverConfiguration:
    name: str
    dg: DGModel
    q: object
    aux: object
    dt: float
    t0: float
    timeend: float
    solver: object
    driver_config: DriverConfiguration
    cfl: float = 0.4
    cfl_direction: str = "every"
    ode_solver_type: object = None


def make_solver_configuration(
        t0: float, timeend: float, driver_config: DriverConfiguration,
        ode_solver_type=None, Courant_number: Optional[float] = None,
        ode_dt: Optional[float] = None, CFL_direction: str = "every",
        restart_from: Optional[tuple] = None) -> SolverConfiguration:
    """The runnable configuration of ``driver_config`` from t0 (the
    checkpoint's with ``restart_from``) to ``timeend`` (a ``timeend``
    not after t0 leaves dt as computed)."""
    dc = driver_config
    dg = DGModel(dc.model, dc.grid,
                 numerical_flux_first_order=dc.numerical_flux_first_order,
                 numerical_flux_gradient=dc.numerical_flux_gradient,
                 numerical_flux_second_order=dc.numerical_flux_second_order)
    if restart_from is not None:
        directory, num = restart_from
        qn, auxn, t0, _ = read_checkpoint(directory, dc.name, num)
        q, aux = state_from_numpy(qn, auxn, device=dc.grid.device,
                                  dtype=dc.grid.dtype, model=dc.model)
    else:
        q, aux = init_ode_state(dg, t0)
    cn = Courant_number if Courant_number is not None else 0.4
    if ode_dt is not None:
        dt = float(ode_dt)
    else:
        dt = calculate_dt(dc.grid, dc.model, q, aux, cn,
                          direction=CFL_direction,
                          local_courant=nondiffusive_courant)
    # land exactly on timeend
    if timeend > t0:
        nsteps = max(int(math.ceil((timeend - t0) / dt - 1e-12)), 1)
        dt = (timeend - t0) / nsteps
    solver_type = ode_solver_type or ExplicitSolverType()
    solver = solver_type.make(dg, q, aux, dt)
    if SETTINGS.debug_init:
        os.makedirs(SETTINGS.output_dir, exist_ok=True)
        vtk_dump_state(os.path.join(SETTINGS.output_dir, f"{dc.name}_init"),
                       dg, q)
        show_not_finite_fields(dc.model.prog_spec, q, "init_prognostic")
        show_not_finite_fields(dc.model.aux_spec, aux, "init_auxiliary")
    return SolverConfiguration(name=dc.name, dg=dg, q=q, aux=aux, dt=dt,
                               t0=t0, timeend=timeend, solver=solver,
                               driver_config=dc, cfl=cn,
                               cfl_direction=CFL_direction,
                               ode_solver_type=solver_type)
