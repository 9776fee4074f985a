"""Interpolation of DG nodal data to regular diagnostic grids (port of
``climatemachine_tpu/mesh/interpolation.py``: ``lagrange_weights``,
``InterpolationBrick``, ``InterpolationCubedSphere``,
``project_cubed_sphere``).

Each target point's element and its per-dimension Lagrange weights are
found once on the host (vectorised numpy); the interpolation itself
gathers the points' elements and contracts the tensor-product weights
on the grid's device, in chunks of :data:`CHUNK_POINTS` points and one
variable at a time, so that the gathered ``[points, Np]`` block stays
small at any target grid (the GCM's 91 × 180 × 32 points at p4 would
be 262 MB a scalar in float32 whole).  The element of a point is
``eh · n_vert + ev`` on a stack, the order of the port's topologies.

The JAX package gathers the shards of a multi-controller array to every
host before the element gather (its ``_TensorInterpolator.__call__``);
the port runs on one card, so that step has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from climatemachine_tpu_torch.mesh.topology import _cube_panel_axes

#: target points gathered and contracted at once
CHUNK_POINTS = 1 << 16


def _barycentric_weights(xi: np.ndarray) -> np.ndarray:
    N = len(xi)
    w = np.ones(N)
    for j in range(N):
        for k in range(N):
            if k != j:
                w[j] /= (xi[j] - xi[k])
    return w


def lagrange_weights(xi: np.ndarray, x: np.ndarray) -> np.ndarray:
    """[P, Nq] interpolation weights of nodes ``xi`` at points ``x``."""
    wb = _barycentric_weights(xi)
    d = x[:, None] - xi[None, :]
    exact = np.abs(d) < 1e-14
    d = np.where(exact, 1.0, d)
    num = wb[None, :] / d
    out = num / num.sum(axis=1, keepdims=True)
    onrow = exact.any(axis=1)
    out[onrow] = exact[onrow].astype(np.float64)
    return out


class _TensorInterpolator:
    """Per-point element ids and per-dimension weights, on the grid's
    device in its dtype."""

    def __init__(self, grid, elem: np.ndarray, wlist, out_shape):
        self.grid = grid
        self.elem = torch.as_tensor(np.asarray(elem), dtype=torch.int64,
                                    device=grid.device)
        self.w = [torch.as_tensor(w, dtype=grid.dtype, device=grid.device)
                  for w in wlist]
        self.out_shape = tuple(out_shape)

    def __call__(self, f):
        """A scalar field ``[E, Np]`` → ``out_shape``; var-major fields
        ``[E, n, Np]`` → ``[*out_shape, n]`` (the component last, as
        :func:`project_cubed_sphere` takes a vector)."""
        g = self.grid
        single = f.dim() == 2
        fv = f[:, None] if single else f
        n, P = fv.shape[1], self.elem.shape[0]
        out = fv.new_empty((P, n))
        for s in range(0, P, CHUNK_POINTS):
            e = self.elem[s:s + CHUNK_POINTS]
            w = [wd[s:s + CHUNK_POINTS] for wd in self.w]
            for v in range(n):
                # nodes slowest-first: [p, (k,) j, i]
                fe = fv[:, v].index_select(0, e).view(
                    (-1,) + tuple(g.Nq[::-1]))
                for d in range(g.dim):
                    fe = torch.sum(fe * w[d].view(
                        (-1,) + (1,) * (g.dim - 1 - d) + (w[d].shape[1],)),
                        dim=-1)
                out[s:s + CHUNK_POINTS, v] = fe
        out = out.view(self.out_shape + (n,))
        return out[..., 0] if single else out


def _element_interfaces(grid):
    """Each dimension's element interfaces of an axis-aligned brick
    grid: the elements' extents along it, rounded to 9 decimals."""
    c = grid.coords.detach().cpu().double().numpy()
    lo, hi = c.min(axis=1), c.max(axis=1)
    return [np.unique(np.round(np.concatenate([lo[:, d], hi[:, d]]), 9))
            for d in range(grid.dim)]


def InterpolationBrick(grid, x1g, x2g, x3g) -> _TensorInterpolator:
    """Interpolate onto the tensor grid x1g × x2g × x3g (a stacked or
    plain 3-D brick grid with axis-aligned elements)."""
    interfaces = _element_interfaces(grid)
    P1, P2, P3 = len(x1g), len(x2g), len(x3g)
    X1, X2, X3 = np.meshgrid(x1g, x2g, x3g, indexing="ij")
    pts = np.stack([X1.reshape(-1), X2.reshape(-1), X3.reshape(-1)],
                   axis=-1)

    idx, xi_loc = [], []
    for d in range(3):
        iv = interfaces[d]
        i = np.clip(np.searchsorted(iv, pts[:, d], side="right") - 1,
                    0, len(iv) - 2)
        idx.append(i)
        x0, x1 = iv[i], iv[i + 1]
        xi_loc.append(2 * (pts[:, d] - x0) / (x1 - x0) - 1)

    nel = [len(iv) - 1 for iv in interfaces]
    if grid.n_vert is not None:            # stacked: e = eh * nv + ev
        eh = idx[0] + nel[0] * idx[1]
        elem = eh * nel[2] + idx[2]
    else:
        elem = idx[0] + nel[0] * (idx[1] + nel[1] * idx[2])

    wl = [lagrange_weights(grid.xi[d], xi_loc[d]) for d in range(3)]
    interp = _TensorInterpolator(grid, elem, wl, (P1, P2, P3))
    interp.xyz = (np.asarray(x1g), np.asarray(x2g), np.asarray(x3g))
    return interp


def _radial_interfaces(grid):
    """The stack's n_vert + 1 radii, from the nodal radii of the first
    column (float64 of the grid's coordinates)."""
    c = grid.coords[:grid.n_vert].detach().cpu().double().numpy()
    r = np.linalg.norm(c, axis=-1)                    # [n_vert, Np]
    return np.concatenate([r.min(axis=1), r.max(axis=1)[-1:]])


def InterpolationCubedSphere(grid, lats_deg, lons_deg, rads
                             ) -> _TensorInterpolator:
    """Interpolate onto the (lat, lon, radius) tensor grid of a stacked
    cubed sphere; ``rads`` are absolute radii [m]."""
    n_horz = int(round(np.sqrt(grid.n_horz / 6)))
    n_vert = grid.n_vert
    vert_range = _radial_interfaces(grid)

    lats = np.deg2rad(np.asarray(lats_deg, dtype=np.float64))
    lons = np.deg2rad(np.asarray(lons_deg, dtype=np.float64))
    LAT, LON, RAD = np.meshgrid(lats, lons, np.asarray(rads),
                                indexing="ij")
    shape = LAT.shape
    lat, lon, rad = LAT.reshape(-1), LON.reshape(-1), RAD.reshape(-1)

    u = np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                  np.sin(lat)], axis=-1)

    # the panel and the inverse of the equiangular warp
    dots = np.zeros((len(lat), 6))
    t1 = np.zeros((len(lat), 6))
    t2 = np.zeros((len(lat), 6))
    for p in range(6):
        nrm, ta, tb = _cube_panel_axes(p)
        dn = u @ nrm
        dots[:, p] = dn
        with np.errstate(divide="ignore", invalid="ignore"):
            t1[:, p] = (4 / np.pi) * np.arctan2(u @ ta, dn)
            t2[:, p] = (4 / np.pi) * np.arctan2(u @ tb, dn)
    panel = np.argmax(dots, axis=1)
    ar = np.arange(len(lat))
    t1 = np.clip(t1[ar, panel], -1.0, 1.0)
    t2 = np.clip(t2[ar, panel], -1.0, 1.0)

    lin = np.linspace(-1.0, 1.0, n_horz + 1)
    ia = np.clip(np.searchsorted(lin, t1, side="right") - 1, 0, n_horz - 1)
    jb = np.clip(np.searchsorted(lin, t2, side="right") - 1, 0, n_horz - 1)
    xi1 = 2 * (t1 - lin[ia]) / (lin[ia + 1] - lin[ia]) - 1
    xi2 = 2 * (t2 - lin[jb]) / (lin[jb + 1] - lin[jb]) - 1

    ev = np.clip(np.searchsorted(vert_range, rad, side="right") - 1,
                 0, n_vert - 1)
    xi3 = 2 * (rad - vert_range[ev]) / (vert_range[ev + 1]
                                        - vert_range[ev]) - 1

    eh = panel * n_horz * n_horz + jb * n_horz + ia
    elem = eh * n_vert + ev

    # the element's corner angles are affine in ξ, so Lagrange weights at
    # the ξ of the equiangular coordinates are exact for its tensor basis
    wl = [lagrange_weights(grid.xi[0], xi1),
          lagrange_weights(grid.xi[1], xi2),
          lagrange_weights(grid.xi[2], xi3)]
    interp = _TensorInterpolator(grid, elem, wl, shape)
    interp.latlon = (lats_deg, lons_deg, rads)
    return interp


def project_cubed_sphere(coords_latlon, vec_cart):
    """Rotate Cartesian vectors ``[nlat, nlon, ..., 3]`` (numpy) to
    (zonal, meridional, radial) at the target points of ``coords_latlon``
    = (lats, lons) in degrees."""
    lat, lon = (np.deg2rad(np.asarray(a, dtype=np.float64))
                for a in coords_latlon)
    LAT, LON = np.meshgrid(lat, lon, indexing="ij")
    v = np.asarray(vec_cart)
    tail = (1,) * (v.ndim - 3)
    sinl, cosl, sinn, cosn = (a.reshape(a.shape + tail) for a in (
        np.sin(LAT), np.cos(LAT), np.sin(LON), np.cos(LON)))
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return np.stack([-sinn * vx + cosn * vy,
                     -sinl * cosn * vx - sinl * sinn * vy + cosl * vz,
                     cosl * cosn * vx + cosl * sinn * vy + sinl * vz],
                    axis=-1)
