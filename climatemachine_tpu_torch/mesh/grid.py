"""Discontinuous spectral-element grid on the device (port of
``climatemachine_tpu/mesh/grid.py``: _fmask :36, _apply_orient_edge :81,
make_grid :144, min_node_distance :333, the stack metadata
n_horz/n_vert :132-133), on a stacked cubed sphere or a 3-D or 2-D
brick (periodic faces are interior faces whose neighbour wraps around).
A 2-D grid (``dim`` 2, 4 faces) carries coordinates ``[E, Np, 2]``,
``xi_x`` ``[E, Np, 2, 2]`` and normals ``[E, 4, Nfp_max, 2]``: the
barotropic ocean's.

The geometry is built once in numpy float64 on the host and uploaded in
the run dtype, as the JAX package does.  The grid carries what the
var-major explicit step reads: nodal coordinates, metrics (the vertical
line Jacobian ``JcV`` of the stack integrals among them), mass, face
normals and weights, the 0/1 lift matrix, the fused weak-divergence
operator ``Wdiv``, the stacked derivative operator ``Wgrad``, the
face-row neighbour tables and the stack's ``n_horz``/``n_vert`` (element
``e = eh * n_vert + ev``), which the column solvers read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from climatemachine_tpu_torch.device import resolve_device
from climatemachine_tpu_torch.dg.directions import direction_dims
from climatemachine_tpu_torch.mesh import elements, metrics
from climatemachine_tpu_torch.mesh.topology import Topology


def _fmask(Nq: Tuple[int, ...]):
    """Per-face volume-node indices in tangential order (first tangent
    fastest), node n = i + Nq1*(j + Nq2*k), in 2-D n = i + Nq1*j."""
    if len(Nq) == 2:
        ids = np.arange(np.prod(Nq)).reshape(Nq[1], Nq[0])      # [j, i]
        faces = [ids[:, 0], ids[:, -1], ids[0, :], ids[-1, :]]
    else:
        ids = np.arange(np.prod(Nq)).reshape(Nq[2], Nq[1], Nq[0])
        faces = [ids[:, :, 0], ids[:, :, -1], ids[:, 0, :], ids[:, -1, :],
                 ids[0, :, :], ids[-1, :, :]]
    return [np.ascontiguousarray(f.reshape(-1)) for f in faces]


def _apply_orient_quad(code: int, Na: int, Nb: int):
    """My face node p → the neighbour's face node for orientation
    ``code`` (bit0 flip-a, bit1 flip-b, bit2 swap-ab)."""
    ta, tb = np.meshgrid(np.arange(Na), np.arange(Nb), indexing="xy")
    ta, tb = ta.reshape(-1), tb.reshape(-1)
    if code & 4:
        u, v, Nap, Nbp = tb, ta, Nb, Na
    else:
        u, v, Nap, Nbp = ta, tb, Na, Nb
    ap = (Nap - 1 - u) if code & 1 else u
    bp = (Nbp - 1 - v) if code & 2 else v
    return ap + Nap * bp


def _apply_orient_edge(code: int, Nt: int):
    """My edge node p → the neighbour's for orientation ``code`` (0 the
    same direction, 1 reversed)."""
    p = np.arange(Nt)
    return (Nt - 1 - p) if code else p


@dataclass
class Grid:
    """Static per-grid data: device tensors plus host metadata."""
    Nq: Tuple[int, ...]            # nodes per reference dim
    Np: int
    Nfp: Tuple[int, ...]           # face nodes per face
    Nfp_max: int
    xi: Tuple[np.ndarray, ...]     # host: 1-D LGL nodes in [-1, 1]
    coords: torch.Tensor           # [E, Np, dim]
    M: torch.Tensor                # [E, Np]  w⊗J
    MI: torch.Tensor               # [E, Np]
    J: torch.Tensor                # [E, Np]
    JcV: torch.Tensor              # [E, Np]  |dx/dξ_dim|, the column's dz/dξ
    xi_x: torch.Tensor             # [E, Np, dim, dim] d xi_a / d x_i [a, i]
    normals: torch.Tensor          # [E, nface, Nfp_max, dim]
    sM: torch.Tensor               # [E, nface, Nfp_max]
    face_bctag: torch.Tensor       # [E, nface] int64, 0 = interior
    lift: torch.Tensor             # [Np, nface*Nfp_max] 0/1
    face_nbr_row: torch.Tensor     # [E, nface] int64 = nbr e * nface + face
    face_perm_identity: bool       # every face orientation is identity
    Wdiv: torch.Tensor             # [Np, dim*Np]  Σ_a D_aᵀ-Kronecker
    Wgrad: torch.Tensor            # [dim*Np, Np]  D_a-Kronecker stacked
    fmask_padded: np.ndarray       # host [nface, Nfp_max] face node ids
    n_horz: Optional[int] = None   # horizontal elements of the stack
    n_vert: Optional[int] = None   # vertical elements of the stack
    dim: int = 3

    @property
    def nface(self) -> int:
        return 2 * self.dim

    @property
    def nelem(self) -> int:
        return self.coords.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.coords.dtype

    @property
    def device(self) -> torch.device:
        return self.coords.device


def make_grid(topology: Topology, polyorder: int,
              dtype: torch.dtype = torch.float32, device=None) -> Grid:
    """Build a :class:`Grid` of polynomial order ``polyorder`` on a 3-D or
    2-D topology; ``device=None`` means CUDA."""
    device = resolve_device(device)
    dim = topology.dim
    xi, w, D = [], [], []
    for _ in range(dim):
        x_d, w_d = elements.lgl_points(polyorder)
        xi.append(x_d)
        w.append(w_d)
        D.append(elements.derivative_matrix(x_d))
    Nq = (polyorder + 1,) * dim
    Np = int(np.prod(Nq))

    coords = metrics.nodal_coordinates(topology.elem_to_coord, xi, dim)
    if topology.meshwarp is not None:
        coords = np.stack(topology.meshwarp(
            *(coords[..., i] for i in range(dim))), axis=-1)
    geo = (metrics.geometry_3d if dim == 3 else metrics.geometry_2d)(
        coords, D, w)

    Nfp = geo["Nfp"]
    Nfp_max = max(Nfp)
    nface = 2 * dim
    fmask = _fmask(Nq)
    fmask_padded = np.zeros((nface, Nfp_max), dtype=np.int64)
    lift = np.zeros((Np, nface * Nfp_max))
    for f in range(nface):
        fmask_padded[f, :Nfp[f]] = fmask[f]
        lift[fmask[f], f * Nfp_max + np.arange(Nfp[f])] = 1.0

    face_nbr_row = topology.face_neighbor * nface + topology.face_neighbor_face
    perm_identity = True
    for f in range(nface):
        tangent = [Nq[t] for t in range(dim) if t != f // 2]
        for code in np.unique(topology.face_orient[:, f]):
            pmap = (_apply_orient_quad(int(code), *tangent) if dim == 3
                    else _apply_orient_edge(int(code), *tangent))
            perm_identity &= bool((pmap == np.arange(Nfp[f])).all())

    def kron_op(a, transpose):              # D_a(ᵀ) on axis a, slowest first
        out = np.ones((1, 1))
        for d in range(dim - 1, -1, -1):
            Da = D[a].T if transpose else D[a]
            out = np.kron(out, Da if d == a else np.eye(Nq[d]))
        return out
    Wdiv = np.concatenate([kron_op(a, True) for a in range(dim)], axis=1)
    Wgrad = np.concatenate([kron_op(a, False) for a in range(dim)], axis=0)

    dev = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    idx = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                    device=device)
    return Grid(
        Nq=Nq, Np=Np, Nfp=tuple(Nfp), Nfp_max=Nfp_max,
        xi=tuple(xi), coords=dev(geo["coords"]), M=dev(geo["M"]),
        MI=dev(geo["MI"]), J=dev(geo["J"]), JcV=dev(geo["JcV"]),
        xi_x=dev(geo["xi_x"]),
        normals=dev(geo["normals"]), sM=dev(geo["sM"]),
        face_bctag=idx(topology.face_bctag), lift=dev(lift),
        face_nbr_row=idx(face_nbr_row), face_perm_identity=perm_identity,
        Wdiv=dev(Wdiv), Wgrad=dev(Wgrad), fmask_padded=fmask_padded,
        n_horz=topology.n_horz, n_vert=topology.n_vert, dim=dim)


def min_node_distance(grid: Grid, direction: str = "every") -> float:
    """Minimum distance between adjacent nodes along the reference
    directions of ``direction`` ("every", "horizontal" or "vertical"),
    from the run-dtype coordinates (for CFL dt estimates)."""
    coords = grid.coords.detach().cpu().numpy().astype(np.float64)
    c = coords.reshape((coords.shape[0],) + tuple(grid.Nq[::-1])
                       + (coords.shape[-1],))
    md = np.inf
    for d in direction_dims(direction, grid.dim):
        diff = np.diff(c, axis=grid.dim - d)
        md = min(md, np.sqrt(np.sum(diff ** 2, axis=-1)).min())
    return float(md)
