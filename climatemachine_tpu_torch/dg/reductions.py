"""Global reductions over var-major DG state (port of
``climatemachine_tpu/dg/reductions.py`` :17-45: ``weightedsum``,
``norm``, ``dot``, ``euclidean_distance``).

State is var-major ``[E, n, Np]``; the grid's mass ``M`` is ``[E, Np]``.
"""

from __future__ import annotations

import torch


def weightedsum(grid, q, field=None):
    """∫ q dV of each field ``[n]`` (the mass-weighted sum), or of field
    number ``field`` alone (a 0-d tensor)."""
    x = q if field is None else q[:, field:field + 1]
    out = torch.sum(grid.M[:, None] * x, dim=(0, 2))
    return out[0] if field is not None else out


def norm(grid, q, weighted: bool = True):
    """The L2 norm of the whole state, M-weighted unless ``weighted`` is
    False."""
    if weighted:
        return torch.sqrt(torch.sum(grid.M[:, None] * q * q))
    return torch.sqrt(torch.sum(q * q))


def dot(grid, a, b, weighted: bool = True):
    if weighted:
        return torch.sum(grid.M[:, None] * a * b)
    return torch.sum(a * b)


def euclidean_distance(grid, a, b, weighted: bool = True):
    """‖a − b‖, M-weighted unless ``weighted`` is False."""
    return norm(grid, a - b, weighted=weighted)
