"""Curvilinear metric terms (port of ``climatemachine_tpu/mesh/metrics.py``:
nodal_coordinates, geometry_3d :52 with the vertical line Jacobian JcV
:88, geometry_2d :157).  Host-side numpy float64.

The contravariant metrics use the discrete curl-invariant form (Kopriva
2006) so free-stream preservation holds on the warped cubed sphere.
Node convention: flat node n = i + Nq1*(j + Nq2*k); blocks are
``[E, Nq3, Nq2, Nq1]`` (k slowest), in 2-D n = i + Nq1*j, ``[E, Nq2,
Nq1]``.
"""

from __future__ import annotations

import numpy as np


def nodal_coordinates(elem_to_coord: np.ndarray, xi, dim: int):
    """Multilinear interpolation of element corner coordinates to LGL
    nodes: ``[E, 2^dim, ncoord]`` → ``[E, Nq_{dim-1}, ..., Nq_0, ncoord]``."""
    E, ncorn, ncoord = elem_to_coord.shape
    out = None
    for c in range(ncorn):
        bs = []
        for d in range(dim - 1, -1, -1):
            bs.append((1 + xi[d]) / 2 if (c >> d) & 1 else (1 - xi[d]) / 2)
        w = bs[0]
        for b in bs[1:]:
            w = np.multiply.outer(w, b)
        term = elem_to_coord[:, c, :][:, None, :] * w.reshape(1, -1, 1)
        out = term if out is None else out + term
    shape = tuple(len(xi[d]) for d in range(dim - 1, -1, -1))
    return out.reshape((E,) + shape + (ncoord,))


def _dmat_apply(D: np.ndarray, x: np.ndarray, refdim: int, dim: int):
    """Apply the 1-D derivative matrix along reference dim ``refdim``."""
    axis = dim - refdim
    return np.moveaxis(np.tensordot(x, D, axes=([axis], [1])), -1, axis)


def geometry_3d(coords: np.ndarray, D, w):
    """Volume and surface geometry of ``coords [E, Nq3, Nq2, Nq1, 3]``.

    Returns J, M = w⊗J, MI and the vertical line Jacobian JcV = |∂x/∂ξ₃|
    as ``[E, Np]``; xi_x ``[E, Np, 3, 3]``
    (d xi_a / d x_i at [a, i]); coords ``[E, Np, 3]``; unit normals
    ``[E, 6, Nfp_max, 3]``; sM ``[E, 6, Nfp_max]`` (tangential weights ×
    J|∇xi_d|); Nfp per face."""
    E = coords.shape[0]
    Nq3, Nq2, Nq1 = coords.shape[1:4]
    Np = Nq1 * Nq2 * Nq3
    x = [coords[..., i] for i in range(3)]

    dx = np.empty((E, Nq3, Nq2, Nq1, 3, 3))      # dx_i / dxi_a at [i, a]
    for a in range(3):
        for i in range(3):
            dx[..., i, a] = _dmat_apply(D[a], x[i], a, 3)

    J = (dx[..., 0, 0] * (dx[..., 1, 1] * dx[..., 2, 2] - dx[..., 2, 1] * dx[..., 1, 2])
         + dx[..., 1, 0] * (dx[..., 2, 1] * dx[..., 0, 2] - dx[..., 0, 1] * dx[..., 2, 2])
         + dx[..., 2, 0] * (dx[..., 0, 1] * dx[..., 1, 2] - dx[..., 1, 1] * dx[..., 0, 2]))
    if np.any(J <= 0):
        raise ValueError(f"non-positive Jacobian: min {J.min():.3e}")
    JcV = np.sqrt(dx[..., 0, 2] ** 2 + dx[..., 1, 2] ** 2 + dx[..., 2, 2] ** 2)

    # J d(xi_a)/d(x_i) = (1/2)[D_{a+1}(V^i_{a+2}) - D_{a+2}(V^i_{a+1})],
    # V^i_a = x_{i+1} d(x_{i+2})/d(xi_a) - x_{i+2} d(x_{i+1})/d(xi_a)
    xi_x = np.zeros((E, Nq3, Nq2, Nq1, 3, 3))
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        V = np.empty((E, Nq3, Nq2, Nq1, 3))
        for a in range(3):
            V[..., a] = x[i1] * dx[..., i2, a] - x[i2] * dx[..., i1, a]
        for a in range(3):
            a1, a2 = (a + 1) % 3, (a + 2) % 3
            xi_x[..., a, i] = 0.5 * (
                _dmat_apply(D[a1], V[..., a2], a1, 3)
                - _dmat_apply(D[a2], V[..., a1], a2, 3)) / J

    wt = np.multiply.outer(np.multiply.outer(w[2], w[1]), w[0])
    M = wt[None] * J
    MI = 1.0 / M

    Nfp = (Nq2 * Nq3, Nq2 * Nq3, Nq1 * Nq3, Nq1 * Nq3, Nq1 * Nq2, Nq1 * Nq2)
    Nfp_max = max(Nfp)
    n_out = np.zeros((E, 6, Nfp_max, 3))
    sM = np.zeros((E, 6, Nfp_max))
    Jxi = xi_x * J[..., None, None]
    for d in range(3):
        for s in (0, 1):
            f = 2 * d + s
            end = -1 if s else 0
            if d == 0:
                sl = (slice(None), slice(None), slice(None), end)
                tw = np.multiply.outer(w[2], w[1]).reshape(-1)
            elif d == 1:
                sl = (slice(None), slice(None), end, slice(None))
                tw = np.multiply.outer(w[2], w[0]).reshape(-1)
            else:
                sl = (slice(None), end, slice(None), slice(None))
                tw = np.multiply.outer(w[1], w[0]).reshape(-1)
            nf = (1.0 if s else -1.0) * Jxi[sl + (d, slice(None))].reshape(E, -1, 3)
            norm = np.linalg.norm(nf, axis=-1)
            n_out[:, f, :Nfp[f], :] = nf / norm[..., None]
            sM[:, f, :Nfp[f]] = norm * tw[None, :]

    flat = lambda a: a.reshape(E, Np)
    return dict(J=flat(J), M=flat(M), MI=flat(MI), JcV=flat(JcV),
                xi_x=xi_x.reshape(E, Np, 3, 3),
                coords=coords.reshape(E, Np, 3),
                normals=n_out, sM=sM, Nfp=Nfp)


def geometry_2d(coords: np.ndarray, D, w):
    """Planar volume and surface geometry of ``coords [E, Nq2, Nq1, 2]``:
    J, M, MI and JcV = |∂x/∂ξ₂| as ``[E, Np]``; xi_x ``[E, Np, 2, 2]``
    (d xi_a / d x_i at [a, i]); coords ``[E, Np, 2]``; unit normals
    ``[E, 4, Nfp_max, 2]``; sM ``[E, 4, Nfp_max]``; Nfp per edge."""
    E, Nq2, Nq1 = coords.shape[:3]
    Np = Nq1 * Nq2
    x = [coords[..., i] for i in range(2)]
    dx = np.empty((E, Nq2, Nq1, 2, 2))            # dx_i / dxi_a at [i, a]
    for a in range(2):
        for i in range(2):
            dx[..., i, a] = _dmat_apply(D[a], x[i], a, 2)
    J = dx[..., 0, 0] * dx[..., 1, 1] - dx[..., 1, 0] * dx[..., 0, 1]
    if np.any(J <= 0):
        raise ValueError(f"non-positive Jacobian: min {J.min():.3e}")
    xi_x = np.zeros((E, Nq2, Nq1, 2, 2))
    xi_x[..., 0, 0] = dx[..., 1, 1] / J
    xi_x[..., 0, 1] = -dx[..., 0, 1] / J
    xi_x[..., 1, 0] = -dx[..., 1, 0] / J
    xi_x[..., 1, 1] = dx[..., 0, 0] / J
    JcV = np.sqrt(dx[..., 0, 1] ** 2 + dx[..., 1, 1] ** 2)

    M = np.multiply.outer(w[1], w[0])[None] * J
    MI = 1.0 / M

    Nfp = (Nq2, Nq2, Nq1, Nq1)
    Nfp_max = max(Nfp)
    n_out = np.zeros((E, 4, Nfp_max, 2))
    sM = np.zeros((E, 4, Nfp_max))
    Jxi = xi_x * J[..., None, None]
    for d in range(2):
        for s in (0, 1):
            f = 2 * d + s
            end = -1 if s else 0
            if d == 0:
                sl, tw = (slice(None), slice(None), end), w[1]
            else:
                sl, tw = (slice(None), end, slice(None)), w[0]
            nf = (1.0 if s else -1.0) * Jxi[sl + (d, slice(None))].reshape(
                E, -1, 2)
            norm = np.linalg.norm(nf, axis=-1)
            n_out[:, f, :Nfp[f], :] = nf / norm[..., None]
            sM[:, f, :Nfp[f]] = norm * tw[None, :]

    flat = lambda a: a.reshape(E, Np)
    return dict(J=flat(J), M=flat(M), MI=flat(MI), JcV=flat(JcV),
                xi_x=xi_x.reshape(E, Np, 2, 2),
                coords=coords.reshape(E, Np, 2),
                normals=n_out, sM=sM, Nfp=Nfp)
