"""Direction splitting of the DG operators (port of
``climatemachine_tpu/dg/spatial.py`` direction_dims/direction_faces
:46-58): which reference dimensions and faces a derivative in direction
"every", "horizontal" or "vertical" acts along."""

from __future__ import annotations

from typing import Tuple

_DIMS = {"every": lambda dim: tuple(range(dim)),
         "horizontal": lambda dim: tuple(range(dim - 1)),
         "vertical": lambda dim: (dim - 1,)}


def direction_dims(direction: str, dim: int) -> Tuple[int, ...]:
    """Reference directions a derivative in ``direction`` ("every",
    "horizontal" or "vertical") acts along."""
    if direction not in _DIMS:
        raise ValueError(direction)
    return _DIMS[direction](dim)


def direction_faces(direction: str, dim: int) -> Tuple[int, ...]:
    """Faces normal to the reference directions of ``direction``."""
    return tuple(f for d in direction_dims(direction, dim)
                 for f in (2 * d, 2 * d + 1))
