"""Cartesian views of spectral-element fields on a rectangular brick
(port of ``climatemachine_tpu/common/cartesian_fields.py``:
``SpectralElementField`` and its maps).

The element order, each element's node permutation and the assembled
grid's node ids are computed once on the host from the grid's
coordinates; ``elements`` is two gathers and ``assemble()`` one
``index_add_`` and a divide by each node's count, on the field's device.
"""

from __future__ import annotations

import numpy as np
import torch


class SpectralElementField:
    """Cartesian view of a node field ``[E, Np]`` on a brick.

    - ``elements``: ``[Nex, Ney, Nez, Nqx, Nqy, Nqz]``, by element (i, j,
      k) then local node (a, b, c), x, y and z increasing;
    - ``assemble()``: the continuous ``[nx, ny, nz]`` array, nodes shared
      by elements averaged, nx = Nex·(Nqx − 1) + 1;
    - ``x``, ``y``, ``z``: the assembled 1-D coordinates (numpy)."""

    def __init__(self, grid, data, Ne=None):
        E, Np = int(grid.nelem), int(grid.Np)
        if data.dim() != 2 or data.shape[0] != E or data.shape[1] != Np:
            raise ValueError(f"expected node field [E={E}, Np={Np}], "
                             f"got {tuple(data.shape)}")
        self.grid = grid
        self.data = data
        key = ("cartesian_field_maps",) + ((tuple(Ne),) if Ne else ())
        cache = grid.__dict__.setdefault("_view_cache", {})
        if key not in cache:
            cache[key] = _build_maps(grid, Ne)
        (self.Ne, self.Nq, self._elem_order, self._node_perm,
         self._seg_ids, self._seg_counts, self.x, self.y, self.z) = cache[key]

    @property
    def elements(self):
        """``[Nex, Ney, Nez, Nqx, Nqy, Nqz]`` structured element view."""
        d = self.data.index_select(0, self._elem_order)
        d = d.index_select(1, self._node_perm)
        return d.reshape(tuple(self.Ne) + tuple(self.Nq))

    def assemble(self):
        """The continuous Cartesian array, shared nodes averaged."""
        nx = [ne * (nq - 1) + 1 for ne, nq in zip(self.Ne, self.Nq)]
        s = self.data.new_zeros(nx[0] * nx[1] * nx[2])
        s.index_add_(0, self._seg_ids, self.data.reshape(-1))
        return (s / self._seg_counts).reshape(nx)

    def __array__(self, dtype=None):
        out = self.assemble().detach().cpu().numpy()
        return out.astype(dtype) if dtype is not None else out


def _rank(vals):
    """Ranks of ``vals`` with values within a relative tolerance of
    each other ranked together (round-off perturbs nominally equal
    coordinates), and their count."""
    order = np.argsort(vals)
    sv = vals[order]
    span = float(sv[-1] - sv[0]) or 1.0
    tol = span * float(np.finfo(vals.dtype).eps) ** 0.5
    cluster = np.concatenate([[0], np.cumsum(np.diff(sv) > tol)])
    ranks = np.empty(len(vals), np.int64)
    ranks[order] = cluster
    return ranks, int(cluster[-1]) + 1


def _build_maps(grid, Ne=None):
    """Host maps: the elements in (i, j, k) order, each element's node
    permutation to (a, b, c), the assembled nodes' ids and counts."""
    coords = grid.coords.detach().cpu().numpy()          # [E, Np, 3]
    E, Np = coords.shape[:2]
    Nq = tuple(int(n) for n in grid.Nq)
    dev = grid.coords.device
    corners = coords.min(axis=1)
    ix, nex = _rank(corners[:, 0])
    iy, ney = _rank(corners[:, 1])
    iz, nez = _rank(corners[:, 2])
    if Ne is not None and tuple(Ne) != (nex, ney, nez):
        raise ValueError(f"domain Ne {tuple(Ne)} does not match grid "
                         f"element counts {(nex, ney, nez)}")
    if nex * ney * nez != E:
        raise ValueError("grid is not a full tensor brick")
    elem_order = np.argsort((ix * ney + iy) * nez + iz)

    c0 = coords[elem_order[0]]
    ra, na = _rank(c0[:, 0])
    rb, nb = _rank(c0[:, 1])
    rc, nc = _rank(c0[:, 2])
    if (na, nb, nc) != Nq:
        raise ValueError(f"element node lattice {(na, nb, nc)} does not "
                         f"match Nq {Nq}")
    node_perm = np.argsort((ra * nb + rb) * nc + rc)

    nqx, nqy, nqz = Nq
    nx = [n_e * (n_q - 1) + 1 for n_e, n_q in zip((nex, ney, nez), Nq)]
    a, b, c = np.meshgrid(np.arange(nqx), np.arange(nqy), np.arange(nqz),
                          indexing="ij")
    local = np.stack([a.ravel(), b.ravel(), c.ravel()], axis=-1)
    inv_perm = np.empty(Np, np.int64)
    inv_perm[node_perm] = np.arange(Np)
    gi = ix[:, None] * (nqx - 1) + local[inv_perm][None, :, 0]
    gj = iy[:, None] * (nqy - 1) + local[inv_perm][None, :, 1]
    gk = iz[:, None] * (nqz - 1) + local[inv_perm][None, :, 2]
    seg = ((gi * nx[1] + gj) * nx[2] + gk).ravel()
    counts = np.bincount(seg, minlength=nx[0] * nx[1] * nx[2])

    def axis_coords(dim, g):
        out = np.zeros(nx[dim])
        out[g.ravel()] = coords[..., dim].ravel()
        return out

    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
    return ((nex, ney, nez), Nq, idx(elem_order), idx(node_perm), idx(seg),
            torch.as_tensor(counts, dtype=grid.coords.dtype, device=dev),
            axis_coords(0, gi), axis_coords(1, gj), axis_coords(2, gk))
