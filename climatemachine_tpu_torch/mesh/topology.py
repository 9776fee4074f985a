"""Brick, stacked brick and stacked cubed-sphere topologies (port of
``climatemachine_tpu/mesh/topology.py``: ``StackInfo`` :54,
brick_topology :164-224 in 2 and 3 dimensions with its ``boundary``
tags and ``meshwarp``,
stacked_brick_topology :227-251, _permute_topology :254,
stacked_cubed_sphere_topology :508, single_stack_topology :568, cubed_shell_vertices :290, the
equiangular warp :327 and the numpy face matcher of
connect_from_vertices :110-161).

Host-side numpy.  Face ``f = 2*d + s`` is the reference face with
``xi_d = -1`` (s=0) or ``+1`` (s=1).  Stacked topologies order their
elements column-major, ``e = eh * n_vert + ev``, and carry the stack's
``n_horz`` (horizontal elements) and ``n_vert``.  On the stacked cubed
sphere xi3 is radial, so faces 4/5 are bottom/top, with boundary tags 1
and 2.  The 3-D brick orders its elements dim 0 fastest, is not stacked
(``n_horz`` and ``n_vert`` are None) and has identity face
orientations; the stacked brick is the brick renumbered column-major,
its last dimension vertical.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np

# shell edges: corner c = ca + 2*cb; face f lists its two corners
_FACE_CORNERS_2D = (
    (0, 2),  # f0: a-, tangential b
    (1, 3),  # f1: a+
    (0, 1),  # f2: b-, tangential a
    (2, 3),  # f3: b+
)


@dataclass
class Topology:
    """A hexahedral (3-D) or quadrilateral (2-D) topology: corners and
    face connectivity; ``nface = 2 · dim``."""
    elem_to_coord: np.ndarray       # [E, 2^dim, dim] corners, pre-warp
    face_neighbor: np.ndarray       # [E, nface] neighbour (self at a wall)
    face_neighbor_face: np.ndarray  # [E, nface] face id on the neighbour
    face_orient: np.ndarray         # [E, nface] orientation code
    face_bctag: np.ndarray          # [E, nface] 0 interior, >= 1 a wall tag
    meshwarp: Optional[Callable] = None   # nodal warp (x1, ...) -> same
    n_horz: Optional[int] = None    # horizontal elements of a stack
    n_vert: Optional[int] = None    # vertical elements of a stack

    @property
    def dim(self) -> int:
        return self.elem_to_coord.shape[-1]

    @property
    def stack(self) -> Optional["StackInfo"]:
        """The stack's bookkeeping, None for a topology that is not
        stacked."""
        if self.n_vert is None:
            return None
        return StackInfo(self.n_horz, self.n_vert)


@dataclass(frozen=True)
class StackInfo:
    """Stacked-topology bookkeeping: ``e = eh * n_vert + ev``."""
    n_horz: int
    n_vert: int


def _orient_code_edge(my_corners, nb_corners) -> int:
    if tuple(my_corners) == tuple(nb_corners):
        return 0
    if tuple(my_corners) == tuple(nb_corners[::-1]):
        return 1
    raise ValueError("no orientation matches edge corner ids")


def connect_edges(elem_to_vertex: np.ndarray):
    """Face connectivity of a quad surface mesh from its element → vertex
    table: edges sharing a vertex pair are matched, unmatched edges
    become boundaries with tag 1.  Returns (face_neighbor,
    face_neighbor_face, face_orient, face_bctag)."""
    nelem, nface = elem_to_vertex.shape[0], 4
    neighbor = np.arange(nelem)[:, None].repeat(nface, axis=1)
    neighbor_face = np.tile(np.arange(nface), (nelem, 1))
    orient = np.zeros((nelem, nface), dtype=np.int32)
    bctag = np.zeros((nelem, nface), dtype=np.int32)

    corners = [[tuple(elem_to_vertex[e, list(_FACE_CORNERS_2D[f])])
                for f in range(nface)] for e in range(nelem)]
    face_key = {}
    for e in range(nelem):
        for f in range(nface):
            face_key.setdefault(tuple(sorted(corners[e][f])), []).append((e, f))
    for members in face_key.values():
        if len(members) == 1:
            e, f = members[0]
            bctag[e, f] = 1
        elif len(members) == 2:
            (e0, f0), (e1, f1) = members
            neighbor[e0, f0], neighbor_face[e0, f0] = e1, f1
            neighbor[e1, f1], neighbor_face[e1, f1] = e0, f0
            orient[e0, f0] = _orient_code_edge(corners[e0][f0],
                                               corners[e1][f1])
            orient[e1, f1] = orient[e0, f0]
        else:
            raise ValueError(f"face shared by {len(members)} elements")
    return neighbor, neighbor_face, orient, bctag


def _cube_panel_axes(panel: int):
    """Panel → (outward normal, tangent a, tangent b), right-handed so
    warped element Jacobians stay positive."""
    e0, e1, e2 = np.eye(3)
    return [(e0, e1, e2), (-e0, e2, e1), (e1, e2, e0),
            (-e1, e0, e2), (e2, e0, e1), (-e2, e1, e0)][panel]


def cubed_shell_vertices(n_horz: int):
    """Vertices of the 6·n² quad mesh of the cube [-1,1]³ surface, shared
    vertices deduplicated.  Returns (elem_to_vertex [E,4],
    elem_to_coord [E,4,3]); elements panel-major, ``a`` fastest."""
    n = n_horz
    verts = {}
    E = 6 * n * n
    elem_to_vertex = np.zeros((E, 4), dtype=np.int64)
    elem_to_coord = np.zeros((E, 4, 3))
    lin = np.linspace(-1.0, 1.0, n + 1)
    e = 0
    for panel in range(6):
        nrm, ta, tb = _cube_panel_axes(panel)
        for jb in range(n):
            for ia in range(n):
                for c in range(4):
                    ca, cb = c & 1, (c >> 1) & 1
                    p = nrm + lin[ia + ca] * ta + lin[jb + cb] * tb
                    key = tuple(np.round(p, 12))
                    elem_to_vertex[e, c] = verts.setdefault(key, len(verts))
                    elem_to_coord[e, c] = p
                e += 1
    return elem_to_vertex, elem_to_coord


def equiangular_cubed_sphere_warp(x1, x2, x3):
    """Equiangular gnomonic projection of points on the cube of half-width
    R = max|x_i| onto the sphere of radius R."""
    R = np.maximum(np.maximum(np.abs(x1), np.abs(x2)), np.abs(x3))
    a1, a2, a3 = np.abs(x1), np.abs(x2), np.abs(x3)
    safe_R = np.where(R == 0, 1, R)
    out = np.zeros(np.shape(x1) + (3,))

    def project(t1, t2, s_dom):
        eta1 = np.tan(np.pi / 4 * t1 / safe_R)
        eta2 = np.tan(np.pi / 4 * t2 / safe_R)
        den = np.sqrt(1 + eta1 ** 2 + eta2 ** 2)
        return s_dom * R / den, R * eta1 / den, R * eta2 / den

    dom_1 = (a1 >= a2) & (a1 >= a3)
    dom_2 = (~dom_1) & (a2 >= a3)
    dom_3 = ~(dom_1 | dom_2)
    # (mask, dominant axis, tangential axes, projected inputs)
    for mask, d, (t1, t2), args in (
            (dom_1, 0, (1, 2), (x2, x3, np.sign(x1))),
            (dom_2, 1, (0, 2), (x1, x3, np.sign(x2))),
            (dom_3, 2, (0, 1), (x1, x2, np.sign(x3)))):
        pd, pa, pb = project(*args)
        out[..., d] = np.where(mask, pd, out[..., d])
        out[..., t1] = np.where(mask, pa, out[..., t1])
        out[..., t2] = np.where(mask, pb, out[..., t2])
    return out[..., 0], out[..., 1], out[..., 2]


def stacked_cubed_sphere_topology(n_horz: int,
                                  vert_range: np.ndarray) -> Topology:
    """3-D stacked cubed sphere: the 6·n_horz² shell times a radial stack
    at radii ``vert_range`` (n_vert + 1 interfaces), equiangular warp."""
    shell_e2v, shell_coord = cubed_shell_vertices(n_horz)
    s_nb, s_nbf, s_orient, s_bctag = connect_edges(shell_e2v)
    assert (s_bctag == 0).all(), "cubed shell must be closed"
    vert_range = np.asarray(vert_range, dtype=np.float64)
    n_vert = len(vert_range) - 1
    Eh = shell_e2v.shape[0]
    E = Eh * n_vert

    eh = np.repeat(np.arange(Eh), n_vert)          # [E]
    ev = np.tile(np.arange(n_vert), Eh)            # [E]
    # corners c = ca + 2*cb + 4*cr: shell corner (ca, cb) at radius r_cr
    elem_to_coord = np.zeros((E, 8, 3))
    for c in range(8):
        r = vert_range[ev + (c >> 2)]
        elem_to_coord[:, c] = shell_coord[eh, c & 3] * r[:, None]

    neighbor = np.zeros((E, 6), dtype=np.int64)
    neighbor_face = np.zeros((E, 6), dtype=np.int64)
    orient = np.zeros((E, 6), dtype=np.int32)
    bctag = np.zeros((E, 6), dtype=np.int32)
    # horizontal faces from the shell; an edge flip is a flip of the
    # face's first tangential (the radial one always matches)
    neighbor[:, :4] = s_nb[eh] * n_vert + ev[:, None]
    neighbor_face[:, :4] = s_nbf[eh]
    orient[:, :4] = s_orient[eh]
    e = np.arange(E)
    bottom, top = ev == 0, ev == n_vert - 1
    neighbor[:, 4] = np.where(bottom, e, e - 1)
    neighbor_face[:, 4] = np.where(bottom, 4, 5)
    bctag[:, 4] = np.where(bottom, 1, 0)
    neighbor[:, 5] = np.where(top, e, e + 1)
    neighbor_face[:, 5] = np.where(top, 5, 4)
    bctag[:, 5] = np.where(top, 2, 0)
    return Topology(elem_to_coord, neighbor, neighbor_face, orient, bctag,
                    meshwarp=equiangular_cubed_sphere_warp, n_horz=Eh,
                    n_vert=n_vert)


def brick_topology(ranges: Sequence[np.ndarray],
                   periodicity: Optional[Sequence[bool]] = None,
                   boundary: Optional[np.ndarray] = None,
                   meshwarp: Optional[Callable] = None) -> Topology:
    """Cartesian brick of hexahedra (3 ranges) or quadrilaterals (2):
    ``ranges`` holds each dimension's element interface coordinates
    (nelem_d + 1 of them, possibly stretched), ``periodicity`` which
    dimensions wrap around (default none), ``boundary`` the ``[dim, 2]``
    boundary tags of each (dimension, side) that does not wrap (default 1
    everywhere), ``meshwarp`` a nodal warp of the dim coordinates or
    None.  Elements dim 0 fastest, ``e = ix + nx·(iy + ny·iz)``; every
    face orientation is the identity."""
    dim = len(ranges)
    if dim not in (2, 3):
        raise ValueError(f"brick_topology builds 2-D or 3-D bricks, got "
                         f"{dim} ranges")
    periodicity = (tuple(periodicity) if periodicity is not None
                   else (False,) * dim)
    boundary = (np.ones((dim, 2), dtype=np.int32) if boundary is None
                else np.asarray(boundary))
    nel = [len(r) - 1 for r in ranges]
    E, nface = int(np.prod(nel)), 2 * dim
    idx = np.stack(np.unravel_index(np.arange(E), nel[::-1])[::-1],
                   axis=1)                             # [E, dim] (ix, ...)
    stride = np.cumprod([1] + nel[:-1])
    elem_to_coord = np.zeros((E, 2 ** dim, dim))
    for c in range(2 ** dim):
        for d in range(dim):
            elem_to_coord[:, c, d] = np.asarray(ranges[d])[
                idx[:, d] + ((c >> d) & 1)]
    e = np.arange(E)
    neighbor = np.zeros((E, nface), dtype=np.int64)
    neighbor_face = np.zeros((E, nface), dtype=np.int64)
    bctag = np.zeros((E, nface), dtype=np.int32)
    for d in range(dim):
        for s in (0, 1):
            f = 2 * d + s
            nidx = idx[:, d] + (1 if s else -1)
            inside = (nidx >= 0) & (nidx < nel[d])
            wrap = ~inside & periodicity[d]
            nbr = e + (np.mod(nidx, nel[d]) - idx[:, d]) * stride[d]
            joined = inside | wrap
            neighbor[:, f] = np.where(joined, nbr, e)
            neighbor_face[:, f] = np.where(joined, 2 * d + (1 - s), f)
            bctag[:, f] = np.where(joined, 0, boundary[d, s])
    return Topology(elem_to_coord, neighbor, neighbor_face,
                    np.zeros((E, nface), dtype=np.int32), bctag,
                    meshwarp=meshwarp)


def stacked_brick_topology(ranges: Sequence[np.ndarray],
                           periodicity: Optional[Sequence[bool]] = None,
                           boundary: Optional[np.ndarray] = None,
                           meshwarp: Optional[Callable] = None) -> Topology:
    """The 3-D brick of :func:`brick_topology` with its last dimension
    stacked: element ``e = eh * n_vert + ev`` is the brick's element at
    horizontal index eh (dim 0 fastest) and vertical index ev, so each
    column is contiguous; ``n_horz``, ``n_vert`` set."""
    base = brick_topology(ranges, periodicity, boundary, meshwarp)
    nel = [len(r) - 1 for r in ranges]
    n_vert = nel[-1]
    E = base.face_bctag.shape[0]
    # perm[new] = old: the brick's ids [z, y, x] with z moved fastest
    perm = np.moveaxis(np.arange(E).reshape(nel[::-1]), 0, -1).reshape(-1)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(E)
    topo = _permute_topology(base, perm, inv)
    topo.n_horz, topo.n_vert = E // n_vert, n_vert
    return topo


def single_stack_topology(x_extent: float, y_extent: float,
                          z_range) -> Topology:
    """One vertical column: a single horizontal element of x_extent ×
    y_extent, periodic laterally, over the element interfaces
    ``z_range``, its bottom wall tag 1 and its top tag 2."""
    ranges = [np.array([0.0, x_extent]), np.array([0.0, y_extent]),
              np.asarray(z_range, dtype=np.float64)]
    return stacked_brick_topology(ranges, periodicity=(True, True, False),
                                  boundary=np.array([[0, 0], [0, 0], [1, 2]]))


def _permute_topology(t: Topology, perm: np.ndarray,
                      inv: np.ndarray) -> Topology:
    """Renumber elements: new element i is old element perm[i]; ``inv`` is
    perm's inverse."""
    return Topology(
        elem_to_coord=t.elem_to_coord[perm],
        face_neighbor=inv[t.face_neighbor[perm]],
        face_neighbor_face=t.face_neighbor_face[perm],
        face_orient=t.face_orient[perm],
        face_bctag=t.face_bctag[perm],
        meshwarp=t.meshwarp, n_horz=t.n_horz, n_vert=t.n_vert)
