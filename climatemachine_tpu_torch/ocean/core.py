"""The ocean's vocabulary: coupling modes and boundary conditions (port
of ``climatemachine_tpu/ocean/core.py``, whole: ``OceanBC(velocity,
temperature)`` with velocity Impenetrable or Penetrable × NoSlip,
FreeSlip or KinematicStress, temperature Insulating or TemperatureFlux,
and ``velocity_ghost`` :75).

The ghost rules follow the reference's bc_velocity.jl and
bc_temperature.jl; HydrostaticBoussinesqModel's gradient-flux ghost is
2·target − minus, so that the central average of the surface pass is the
prescribed boundary flux.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch


class Uncoupled:
    pass


class Coupled:
    """The split-explicit coupling with a barotropic model."""


# --- velocity drag/wall conditions -------------------------------------------

class NoSlip:
    pass


class FreeSlip:
    pass


@dataclass
class KinematicStress:
    """``stress(problem, y, t)`` → (τx, τy) ``[E, 2, X]``, the net inward
    kinematic stress; None: the problem's own."""
    stress: Optional[Callable] = None


@dataclass
class Impenetrable:
    drag: object = field(default_factory=NoSlip)


@dataclass
class Penetrable:
    drag: object = field(default_factory=FreeSlip)


# --- temperature conditions ---------------------------------------------------

class Insulating:
    pass


@dataclass
class TemperatureFlux:
    """``flux(problem, y, θ, t)`` → the kinematic temperature flux ``[E,
    X]``."""
    flux: Optional[Callable] = None


@dataclass
class OceanBC:
    velocity: object = field(default_factory=lambda: Impenetrable(NoSlip()))
    temperature: object = field(default_factory=Insulating)


def velocity_ghost(bc, nrm_h, uM):
    """The first-order ghost of the horizontal velocity uM ``[E, 2, X]``
    under the velocity condition ``bc``, with the normal's horizontal
    components ``nrm_h`` ``[E, 2, X]``: −uM at an impenetrable no-slip
    wall, uM with its normal component reflected at an impenetrable
    free-slip or stressed one, uM where the boundary is penetrable."""
    if isinstance(bc, Impenetrable) and isinstance(bc.drag, NoSlip):
        return -uM
    if isinstance(bc, Impenetrable) and isinstance(bc.drag,
                                                   (FreeSlip,
                                                    KinematicStress)):
        un = torch.sum(uM * nrm_h, dim=1, keepdim=True)
        n2 = torch.sum(nrm_h * nrm_h, dim=1, keepdim=True)
        return uM - 2 * un * nrm_h / torch.clamp(n2, min=1e-14)
    return uM
