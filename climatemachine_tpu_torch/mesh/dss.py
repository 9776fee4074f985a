"""Direct stiffness summation: C0-continuous nodal fields (port of
``climatemachine_tpu/mesh/dss.py``: DSSMap :26-66 and dss :69-71).

The nodes that coincide in space are grouped once, on the host, by their
coordinates quantised at ``tol`` of the largest coordinate, which gives
each node one group id for faces, edges and vertices alike; a DSS is
then one scatter-add over the groups and one gather back.  Fields are
var-major ``[E, n, Np]``, as the port's state.
"""

from __future__ import annotations

import numpy as np
import torch


class DSSMap:
    """The grid's node-coincidence map: ``gid`` ``[E·Np]`` (int64, on the
    grid's device) the group of each node (element-major, then node),
    ``count`` each group's multiplicity, ``num_segments`` the groups."""

    def __init__(self, grid, tol: float = 1e-10):
        coords = grid.coords.detach().cpu().numpy()
        coords = coords.reshape(-1, coords.shape[-1])
        scale = np.max(np.abs(coords)) or 1.0
        key = np.round(coords / (scale * tol)).astype(np.int64)
        _, gid, count = np.unique(key, axis=0, return_inverse=True,
                                  return_counts=True)
        self.grid = grid
        self.gid = torch.as_tensor(gid.reshape(-1), device=grid.device)
        self.count = torch.as_tensor(count, dtype=grid.dtype,
                                     device=grid.device)
        self.num_segments = len(count)

    def _node_major(self, x):
        return x.transpose(1, 2).reshape(-1, x.shape[1])

    def _segment_sum(self, flat):
        out = flat.new_zeros((self.num_segments, flat.shape[1]))
        return out.index_add_(0, self.gid, flat)

    def _var_major(self, flat, like):
        E, n, Np = like.shape
        return flat.reshape(E, Np, n).transpose(1, 2).contiguous()

    def sum(self, x):
        """Σ over coincident nodes (the plain stiffness summation) of x
        ``[E, n, Np]``."""
        flat = self._node_major(x)
        return self._var_major(self._segment_sum(flat)[self.gid], x)

    def average(self, x, weighted: bool = True):
        """The C0 projection of x ``[E, n, Np]``: the mass-weighted
        (default) or arithmetic mean over coincident nodes."""
        flat = self._node_major(x)
        if weighted:
            w = self.grid.M.reshape(-1, 1)
            num = self._segment_sum(flat * w)
            den = self._segment_sum(w)
            out = num[self.gid] / den[self.gid]
        else:
            out = (self._segment_sum(flat)[self.gid]
                   / self.count[:, None][self.gid])
        return self._var_major(out, x)


def dss(grid, x, dss_map: DSSMap = None, weighted: bool = True):
    """One-call DSS average of x ``[E, n, Np]`` (a new map unless
    ``dss_map`` is given)."""
    return (dss_map or DSSMap(grid)).average(x, weighted=weighted)
