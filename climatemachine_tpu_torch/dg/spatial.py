"""The (balance law, grid) holder and state initialization (port of
``climatemachine_tpu/dg/spatial.py`` init_state_auxiliary :895,
init_ode_state :909).

The generic node-major ``DGModel.__call__`` is not ported: the explicit
step runs the var-major RHS (dg/fast_rhs.py).  State is var-major.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


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
    model's nodal initialization."""
    coords = grid.coords.transpose(1, 2)                 # [E, 3, Np]
    aux = torch.zeros((grid.nelem, balance_law.aux_spec.num, grid.Np),
                      dtype=grid.dtype, device=grid.device)
    aux[:, balance_law.aux_spec.index("coord")] = coords
    return balance_law.nodal_init_state_auxiliary(coords, aux)


def init_ode_state(dg: DGModel, t0: float = 0.0):
    """Var-major (q0, aux0) from the balance law's initial condition."""
    bl, grid = dg.balance_law, dg.grid
    aux = init_state_auxiliary(bl, grid)
    q = bl.init_state_prognostic(grid.coords.transpose(1, 2), aux, t0)
    return q, bl.update_auxiliary_state(q, aux)
