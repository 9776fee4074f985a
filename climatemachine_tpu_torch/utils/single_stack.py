"""Single-stack (single-column) utilities (port of
``climatemachine_tpu/utils/single_stack.py``): one vertical column's
profiles and the horizontal mean and variance profiles of every lane of
a var-major state ``[E, n, Np]`` on a stacked grid, as numpy."""

from __future__ import annotations

from typing import Dict

import numpy as np

from climatemachine_tpu_torch.diagnostics.atmos_les import _per_node
from climatemachine_tpu_torch.diagnostics.machine import horizontal_average


def get_vars_from_nodal_stack(grid, q, spec, i: int = 0, j: int = 0,
                              eh: int = 0) -> Dict[str, np.ndarray]:
    """The column at horizontal node (i, j) of horizontal element eh:
    {name: [n_vert · Nq3]}."""
    Nq1, Nq2, Nq3 = grid.Nq
    n = q.shape[1]
    qs = q.detach().reshape(grid.n_horz, grid.n_vert, n, Nq3, Nq2, Nq1)
    col = qs[eh, :, :, :, j, i].permute(0, 2, 1).reshape(
        grid.n_vert * Nq3, n).cpu().numpy()
    return {name: col[:, k] for k, name in
            enumerate(spec.flattened_names())}


def get_horizontal_mean(grid, q, spec) -> Dict[str, np.ndarray]:
    """The M-weighted horizontal mean profile of every lane."""
    return {name: horizontal_average(grid, q[:, k]).cpu().numpy()
            for k, name in enumerate(spec.flattened_names())}


def get_horizontal_variance(grid, q, spec) -> Dict[str, np.ndarray]:
    """The horizontal variance profile of every lane: the mean of the
    squared deviation from the mean profile."""
    out = {}
    for k, name in enumerate(spec.flattened_names()):
        f = q[:, k]
        fdev = f - _per_node(grid, horizontal_average(grid, f))
        out[name] = horizontal_average(grid, fdev ** 2).cpu().numpy()
    return out
