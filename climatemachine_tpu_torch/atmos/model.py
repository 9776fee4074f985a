"""The dry atmosphere balance law (port of the parts of
``climatemachine_tpu/atmos/model.py`` the Held-Suarez step uses: the
prognostic/aux schemas :146-203, ``nodal_init_state_auxiliary`` :334,
the dry thermo refresh of the aux lanes and the wall ghost
``boundary_state`` :608-618).

Prognostic: ρ, ρu(3), ρe.  Auxiliary: coord(3), orientation (Φ, ∇Φ),
reference state (ρ, p, T, ρe), moisture (θ_v, T) — 13 lanes in the JAX
package's order — then, with hyperdiffusion, ``hyperdiffusion.delta``.
State and aux are var-major ``[E, n, Np]``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple

import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import AtmosBC
from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
from climatemachine_tpu_torch.common.orientations import SphericalOrientation
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import (EARTH,
                                                         PlanetParameterSet)
from climatemachine_tpu_torch.utils.variables import VarSpec


@dataclass(frozen=True)
class AtmosPhysics:
    """Physics bundle.  ``hyperdiffusion`` is None or a
    :class:`~climatemachine_tpu_torch.atmos.hyperdiffusion.DryBiharmonic`
    (the var-major RHS refuses any other kind)."""
    param_set: PlanetParameterSet = EARTH
    orientation: SphericalOrientation = field(
        default_factory=SphericalOrientation)
    ref_state: HydrostaticState = field(default_factory=HydrostaticState)
    hyperdiffusion: Optional[object] = None


@dataclass(frozen=True)
class AtmosProblem:
    """Initial condition ``(model, coords, aux, t) -> q`` (var-major) and
    one boundary condition per boundary tag."""
    init_state: Callable = None
    boundary_conditions: Tuple[AtmosBC, ...] = (AtmosBC(), AtmosBC())


def _set(arr, sl: slice, val):
    """Copy of ``arr`` with var-major slots ``sl`` replaced by ``val``."""
    out = arr.clone()
    out[:, sl] = val.reshape(out[:, sl].shape)
    return out


class AtmosModel:
    """Dry compressible atmosphere with total energy."""

    def __init__(self, physics: AtmosPhysics, problem: AtmosProblem,
                 sources: Sequence = ()):
        self.physics = physics
        self.problem = problem
        self.sources = tuple(sources)
        self.prog_spec = VarSpec(rho=1, rhou=3, rhoe=1)
        aux_fields = dict(coord=3,
                          orientation=physics.orientation.vars_aux(),
                          ref_state=physics.ref_state.vars_aux(),
                          moisture=VarSpec(theta_v=1, air_T=1))
        hyper = physics.hyperdiffusion
        if hyper is not None:
            aux_fields["hyperdiffusion"] = hyper.vars_aux()
        self.aux_spec = VarSpec(**aux_fields)
        self.gradlap_spec = (hyper.vars_gradient_laplacian()
                             if hyper is not None else VarSpec())
        self.hyperdiffusion_direction = (hyper.direction
                                         if hyper is not None else None)

    @property
    def param_set(self) -> PlanetParameterSet:
        return self.physics.param_set

    @property
    def ref_state(self) -> HydrostaticState:
        return self.physics.ref_state

    def nodal_init_state_auxiliary(self, coords, aux, grid):
        """Fill Φ, ∇Φ and the reference state from coords ``[E, 3, Np]``,
        and the hyperdiffusion lengthscale from the grid's metrics."""
        ps, sp = self.param_set, self.aux_spec
        ori = self.physics.orientation
        Phi = ori.geopotential(ps, coords)
        aux = _set(aux, sp.index("orientation.Phi"), Phi)
        aux = _set(aux, sp.index("orientation.grad_Phi"),
                   ori.grad_geopotential(ps, coords))
        for name, val in self.ref_state.fields(ps, Phi / ps.grav,
                                               Phi).items():
            aux = _set(aux, sp.index(f"ref_state.{name}"), val)
        if self.physics.hyperdiffusion is not None:
            aux = self.physics.hyperdiffusion.init_aux(self, grid, aux)
        return aux

    def init_state_prognostic(self, coords, aux, t):
        return self.problem.init_state(self, coords, aux, t)

    def update_auxiliary_state(self, q, aux):
        """Refresh the dry thermo lanes θ_v and T from the state."""
        ps, sp = self.param_set, self.aux_spec
        rho, rhou, rhoe = q[:, 0], q[:, 1:4], q[:, 4]
        Phi = sp.get(aux, "orientation.Phi")
        ke = 0.5 * torch.sum(rhou * rhou, dim=1) / (rho * rho)
        T = td.air_temperature(ps, rhoe / rho - ke - Phi)
        p = td.air_pressure(ps, T, rho)
        theta_v = T * (ps.MSLP / p) ** ps.kappa_d
        aux = _set(aux, sp.index("moisture.air_T"), T)
        return _set(aux, sp.index("moisture.theta_v"), theta_v)

    def boundary_state(self, tag: int, nrm, q_minus, aux_minus, t):
        """Ghost (q⁺, aux⁺) on wall face lanes of boundary ``tag``:
        q ``[E, 5, X]``, normals ``[E, 3, X]``."""
        bc = self.problem.boundary_conditions[tag - 1]
        return bc.ghost_state(self, nrm, q_minus, aux_minus, t)
