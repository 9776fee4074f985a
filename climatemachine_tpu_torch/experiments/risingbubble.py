"""The dry rising thermal bubble LES (the port's counterpart of
``examples/risingbubble.py``): a 2 K warm bubble of radius 500 m at (x,
z) = (1250, 1000) m in a hydrostatically balanced dry-adiabatic
atmosphere (300 K at the ground, 110 K floor), in a 2500 m cube whose
lateral sides are periodic, with free-slip insulating walls at the
bottom (tag 1) and top (tag 2), Gravity, and the SmagorinskyLilly(0.21)
closure by default (None: inviscid).  Built through the driver's entry:
``AtmosLESConfiguration``, then the caller's
``make_solver_configuration`` and ``invoke``.
"""

from __future__ import annotations

import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import AtmosBC
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
from climatemachine_tpu_torch.atmos.sources import Gravity
from climatemachine_tpu_torch.common.turbulence import SmagorinskyLilly
from climatemachine_tpu_torch.driver.configs import AtmosLESConfiguration
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import EARTH
from climatemachine_tpu_torch.physics.temperature_profiles import \
    DryAdiabaticProfile

BOX = 2500.0
#: bubble centre x, z [m], radius [m], potential-temperature excess [K]
BUBBLE = (1250.0, 1000.0, 500.0, 2.0)
THETA_0 = 300.0

_DEFAULT = object()


def rising_bubble_model(turbulence=_DEFAULT) -> AtmosModel:
    """The bubble's AtmosModel; ``turbulence`` SmagorinskyLilly(0.21)
    unless given (None: inviscid)."""
    ps = EARTH
    if turbulence is _DEFAULT:
        turbulence = SmagorinskyLilly(0.21)
    physics = AtmosPhysics(
        ref_state=HydrostaticState(DryAdiabaticProfile(THETA_0, 110.0)),
        turbulence=turbulence)

    def init(m, coords, aux, t):
        x, z = coords[:, 0], coords[:, 2]
        xc, zc, rc, dtheta = BUBBLE
        p = m.aux_spec.get(aux, "ref_state.p")
        r = torch.sqrt((x - xc) ** 2 + (z - zc) ** 2)
        theta = THETA_0 + dtheta * torch.clamp(1 - r / rc, 0.0, 1.0)
        T = theta * (p / ps.MSLP) ** ps.kappa_d
        rho = p / (ps.R_d * T)
        Phi = m.aux_spec.get(aux, "orientation.Phi")
        return m.prog_spec.pack(
            {"rho": rho, "rhoe": rho * (td.internal_energy(ps, T) + Phi)})

    return AtmosModel(physics, AtmosProblem(
        init_state=init, boundary_conditions=(AtmosBC(), AtmosBC())),
        sources=(Gravity(),))


def risingbubble_config(resolution: float = 25.0, polyorder: int = 4,
                        turbulence=_DEFAULT, dtype=torch.float32,
                        device=None):
    """``AtmosLESConfiguration("risingbubble", ...)`` of the 2500 m cube at
    the nodal resolution Δ = ``resolution`` (elements of Δ·polyorder: 25
    × 25 × 25 at the default Δ = 25 m, p4)."""
    return AtmosLESConfiguration(
        "risingbubble", polyorder, (resolution,) * 3, BOX, BOX, BOX,
        rising_bubble_model(turbulence), dtype=dtype, device=device)
