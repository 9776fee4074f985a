"""The (balance law, grid) holder, the direction helpers and state
initialization (port of ``climatemachine_tpu/dg/spatial.py``
direction_dims/direction_faces :46-58, init_state_auxiliary :895,
init_ode_state :909).

The generic node-major ``DGModel.__call__`` is not ported: the explicit
step runs the var-major RHS (dg/fast_rhs.py).  State is var-major.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

def direction_dims(direction: str, dim: int) -> Tuple[int, ...]:
    """Reference directions a derivative in ``direction`` acts along.
    Only ``"horizontal"`` (DryBiharmonic's) has a caller yet; the JAX
    package's ``"every"`` and ``"vertical"`` raise."""
    if direction != "horizontal":
        raise NotImplementedError(f"direction {direction!r}: next slice")
    return tuple(range(dim - 1))


def direction_faces(direction: str, dim: int) -> Tuple[int, ...]:
    """Faces normal to the reference directions of ``direction``."""
    return tuple(f for d in direction_dims(direction, dim)
                 for f in (2 * d, 2 * d + 1))


@dataclass
class DGModel:
    """A balance law on a grid, discretized in every direction.
    ``remainder`` (a linear model subtracted for IMEX) belongs to a later
    slice; the var-major RHS refuses it."""
    balance_law: object
    grid: object
    remainder: Optional[tuple] = None


def init_state_auxiliary(balance_law, grid):
    """Aux ``[E, naux, Np]`` with the coordinates filled, then the
    model's nodal initialization (which reads the grid's metrics)."""
    coords = grid.coords.transpose(1, 2)                 # [E, 3, Np]
    aux = torch.zeros((grid.nelem, balance_law.aux_spec.num, grid.Np),
                      dtype=grid.dtype, device=grid.device)
    aux[:, balance_law.aux_spec.index("coord")] = coords
    return balance_law.nodal_init_state_auxiliary(coords, aux, grid)


def init_ode_state(dg: DGModel, t0: float = 0.0):
    """Var-major (q0, aux0) from the balance law's initial condition."""
    bl, grid = dg.balance_law, dg.grid
    aux = init_state_auxiliary(bl, grid)
    q = bl.init_state_prognostic(grid.coords.transpose(1, 2), aux, t0)
    return q, bl.update_auxiliary_state(q, aux)
