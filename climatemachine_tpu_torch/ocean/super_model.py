"""The one-call ocean model (port of ``climatemachine_tpu/ocean/
super_model.py``, whole: ``RectangularDomain``, ``InitialConditions``,
``InitialValueProblem``, ``HydrostaticBoussinesqSuperModel`` :90).

It builds the domain's stacked brick, the grid, the
HydrostaticBoussinesqModel, the initial state and the time stepper from
keyword groups, and gives named views of the state (``fields``,
``cartesian_field``) and a ``step``/``solve`` loop.  Like every entry
point of the port it runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Tuple

import numpy as np
import torch

from climatemachine_tpu_torch.ocean import core as oc
from climatemachine_tpu_torch.ocean.hydrostatic_boussinesq import (
    HydrostaticBoussinesqModel)


@dataclass(frozen=True)
class RectangularDomain:
    """Element counts ``Ne``, polynomial order ``Np``, extents and
    periodicity of a box."""
    Ne: Tuple[int, int, int]
    Np: int
    x: Tuple[float, float]
    y: Tuple[float, float]
    z: Tuple[float, float]
    periodicity: Tuple[bool, bool, bool] = (False, False, False)

    @property
    def L(self):
        return (self.x[1] - self.x[0], self.y[1] - self.y[0],
                self.z[1] - self.z[0])


def _zero(x, y, z):
    return torch.zeros_like(x)


@dataclass(frozen=True)
class InitialConditions:
    """Pointwise (x, y, z) → value callables of each field; a field left
    out starts at 0."""
    u: Callable = _zero
    v: Callable = _zero
    eta: Callable = _zero
    theta: Callable = _zero


@dataclass
class InitialValueProblem:
    """A problem from :class:`InitialConditions` and boundary conditions
    (lateral and bottom walls tag 1, the surface tag 2)."""
    Lx: float
    Ly: float
    H: float
    initial_conditions: InitialConditions = field(
        default_factory=InitialConditions)
    boundary_conditions: Tuple[oc.OceanBC, ...] = (
        oc.OceanBC(oc.Impenetrable(oc.FreeSlip()), oc.Insulating()),
        oc.OceanBC(oc.Penetrable(oc.FreeSlip()), oc.Insulating()),
    )

    def coriolis_parameter(self, model, y):
        return model.f_o + model.beta * (y - self.Ly / 2)

    def init_aux(self, model, coords, aux):
        return aux

    def init_state(self, model, coords, aux, t):
        ic = self.initial_conditions
        x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
        s = model.prog_spec
        q = coords.new_zeros((coords.shape[0], s.num, coords.shape[-1]))
        q[:, s.index("u")] = torch.stack([ic.u(x, y, z), ic.v(x, y, z)],
                                         dim=1)
        q[:, s.index("eta").start] = ic.eta(x, y, z)
        q[:, s.index("theta").start] = ic.theta(x, y, z)
        return q

    def kinematic_stress(self, y):
        return y.new_zeros((y.shape[0], 2) + y.shape[1:])


class HydrostaticBoussinesqSuperModel:
    """Grid, equations, state and time stepper from keyword groups;
    ``fields`` gives named views of the current state."""

    def __init__(self, domain: RectangularDomain, time_step: float,
                 initial_conditions: InitialConditions = None,
                 advection=("nonlinear", "nonlinear"),
                 turbulence_closure=dict(nu_h=0.0, nu_z=0.0,
                                         kappa_h=0.0, kappa_z=0.0),
                 coriolis=dict(f_0=0.0, beta=0.0),
                 rusanov_wave_speeds=dict(c_h=0.0, c_z=0.0),
                 buoyancy=dict(alpha_T=0.0),
                 boundary_conditions=None,
                 timestepper="LS3NRK33Heuns",
                 dtype=torch.float64, device=None):
        from climatemachine_tpu_torch.dg.spatial import (DGModel,
                                                         init_ode_state)
        from climatemachine_tpu_torch.mesh.grid import make_grid
        from climatemachine_tpu_torch.mesh.topology import \
            stacked_brick_topology
        from climatemachine_tpu_torch.ode import lsrk3n
        from climatemachine_tpu_torch.ode.lsrk import LSRK54CarpenterKennedy

        self.domain = domain
        Lx, Ly, _ = domain.L
        problem = InitialValueProblem(
            Lx, Ly, -domain.z[0], initial_conditions or InitialConditions())
        if boundary_conditions is not None:
            problem.boundary_conditions = boundary_conditions

        ranges = [np.linspace(domain.x[0], domain.x[1], domain.Ne[0] + 1),
                  np.linspace(domain.y[0], domain.y[1], domain.Ne[1] + 1),
                  np.linspace(domain.z[0], domain.z[1], domain.Ne[2] + 1)]
        nbc = len(problem.boundary_conditions)
        topo = stacked_brick_topology(
            ranges, periodicity=domain.periodicity,
            boundary=np.array([[1, 1], [1, 1], [1, min(2, nbc)]]))
        self.grid = make_grid(topo, domain.Np, dtype=dtype, device=device)

        self.equations = HydrostaticBoussinesqModel(
            problem,
            momentum_advection=advection[0],
            tracer_advection=advection[1],
            c_h=rusanov_wave_speeds.get("c_h", 0.0),
            c_z=rusanov_wave_speeds.get("c_z", 0.0),
            alpha_T=buoyancy.get("alpha_T", 0.0),
            nu_h=turbulence_closure.get("nu_h", 0.0),
            nu_z=turbulence_closure.get("nu_z", 0.0),
            kappa_h=turbulence_closure.get("kappa_h", 0.0),
            kappa_z=turbulence_closure.get("kappa_z", 0.0),
            f_o=coriolis.get("f_0", 0.0),
            beta=coriolis.get("beta", 0.0))

        self.dg = DGModel(self.equations, self.grid)
        self.state, self.aux = init_ode_state(self.dg)
        pre = self.dg.pre_stage
        if timestepper == "LS3NRK33Heuns":
            self.solver = lsrk3n.LS3NRK33Heuns(self.dg, time_step,
                                               pre_stage=pre)
        elif timestepper == "LS3NRK44Classic":
            self.solver = lsrk3n.LS3NRK44Classic(self.dg, time_step,
                                                 pre_stage=pre)
        else:
            self.solver = LSRK54CarpenterKennedy(self.dg, time_step,
                                                 pre_stage=pre)
        self.time = 0.0
        self.step_count = 0

    @property
    def fields(self):
        """{"u", "v", "eta", "theta"} → ``[E, Np]`` views of the state."""
        s = self.equations.prog_spec
        u = s.get(self.state, "u")
        return dict(u=u[:, 0], v=u[:, 1], eta=s.get(self.state, "eta"),
                    theta=s.get(self.state, "theta"))

    def cartesian_field(self, name):
        """The Cartesian view (``.elements``, ``.assemble()``) of a
        prognostic field over the domain."""
        from climatemachine_tpu_torch.common.cartesian_fields import \
            SpectralElementField
        return SpectralElementField(self.grid, self.fields[name],
                                    Ne=self.domain.Ne)

    @property
    def dt(self):
        return self.solver.dt

    def step(self, n: int = 1):
        for _ in range(n):
            self.state, self.aux = self.solver.step(self.state, self.aux,
                                                    self.time)
            self.time += self.solver.dt
            self.step_count += 1
        return self

    def solve(self, until: float):
        """Advance to simulation time ``until``."""
        while self.time < until - 1e-12:
            self.step()
        return self
