"""The port's brick and stacked brick (climatemachine_tpu_torch.mesh)
against the JAX package's, in float64 on the CPU: the LES box of
AtmosLESConfiguration (3 × 3 × 3, lateral sides periodic, the bottom
wall tag 1, the top tag 2), a box walled on every side with six tags,
and a warped box.

- topology tables exactly: elements' corners (the stacked order ``e =
  eh·n_vert + ev``), ``face_neighbor``, ``face_neighbor_face``,
  ``face_orient``, ``face_bctag``, and the stack's n_horz, n_vert;
- the grid at p3 and p4: coordinates and metrics within 1e-13 of the
  largest magnitude of each field, the neighbour rows, boundary tags and
  stack dims exactly, the minimum node distance in each direction;
- the isentropic vortex's call ``brick_topology(ranges, periodicity)``
  and a call without ``boundary``: the tables of the JAX package's
  brick with its default tags (every side that does not wrap tagged 1),
  as the port's brick gave them before it took ``boundary``.
"""

import numpy as np
import pytest
import torch

from climatemachine_tpu.mesh import topology as jax_topology
from climatemachine_tpu.mesh.grid import make_grid as jax_make_grid
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu_torch.mesh import topology
from climatemachine_tpu_torch.mesh.grid import make_grid, min_node_distance

TOL = 1e-13
TABLES = ("elem_to_coord", "face_neighbor", "face_neighbor_face",
          "face_orient", "face_bctag")
FLOAT_FIELDS = ("coords", "J", "M", "MI", "xi_x", "normals", "sM", "lift",
                "Wdiv", "Wgrad")
RANGES = [np.linspace(0.0, 2500.0, 4), np.linspace(0.0, 2500.0, 4),
          np.linspace(0.0, 2500.0, 4)]
STRETCHED = [np.linspace(0.0, 1.0, 4), np.array([0.0, 0.3, 1.1, 2.0]),
             np.array([0.0, 0.1, 0.35, 1.0])]


def _warp(x1, x2, x3):
    """A smooth nodal warp that keeps the box's faces planar at x3 = 0."""
    return x1, x2, x3 + 0.05 * x3 * np.sin(2 * np.pi * x1) * np.cos(
        np.pi * x2)


CASES = {
    "les": (RANGES, (True, True, False), ((0, 0), (0, 0), (1, 2)), None),
    "walled": (STRETCHED, (False, False, False), ((3, 4), (5, 6), (1, 2)),
               None),
    "mixed": (STRETCHED, (False, True, False), ((3, 4), (0, 0), (1, 2)),
              None),
    "warped": (STRETCHED, (True, False, False), ((0, 0), (5, 6), (1, 2)),
               _warp),
}


def _topologies(name, stacked=True):
    ranges, per, bnd, warp = CASES[name]
    build = "stacked_brick_topology" if stacked else "brick_topology"
    args = (ranges, per, np.asarray(bnd), warp)
    return (getattr(jax_topology, build)(*args),
            getattr(topology, build)(*args))


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "brick"])
@pytest.mark.parametrize("name", list(CASES))
def test_topology_tables_match_jax(name, stacked):
    jt, pt = _topologies(name, stacked)
    for key in TABLES:
        np.testing.assert_array_equal(getattr(pt, key), getattr(jt, key),
                                      err_msg=key)
    assert pt.meshwarp is jt.meshwarp
    if stacked:
        assert (pt.n_horz, pt.n_vert) == (jt.stack.n_horz, jt.stack.n_vert)
        assert pt.stack == topology.StackInfo(jt.stack.n_horz,
                                              jt.stack.n_vert)
    else:
        assert pt.stack is None and jt.stack is None


def test_stacked_order_is_column_major():
    """Element eh·n_vert + ev of the stacked box is the brick's element
    at horizontal index eh (dim 0 fastest) and vertical index ev; tag 1
    on the bottom faces of ev = 0, tag 2 on the top faces of the last."""
    pt = topology.stacked_brick_topology(*CASES["les"][:3])
    brick = topology.brick_topology(*CASES["les"][:3])
    nx, ny, nz = (len(r) - 1 for r in RANGES)
    for e in range(nx * ny * nz):
        eh, ev = divmod(e, pt.n_vert)
        old = eh + nx * ny * ev
        np.testing.assert_array_equal(pt.elem_to_coord[e],
                                      brick.elem_to_coord[old])
    ev = np.arange(nx * ny * nz) % nz
    np.testing.assert_array_equal(pt.face_bctag[:, 4], np.where(ev == 0, 1,
                                                                0))
    np.testing.assert_array_equal(pt.face_bctag[:, 5],
                                  np.where(ev == nz - 1, 2, 0))
    assert (pt.face_bctag[:, :4] == 0).all()


@pytest.fixture(scope="module", params=[("les", 3), ("les", 4),
                                        ("walled", 3), ("warped", 3)],
                ids=["les-p3", "les-p4", "walled-p3", "warped-p3"])
def grids(request):
    name, poly = request.param
    jt, pt = _topologies(name)
    return (jax_make_grid(jt, poly, dtype=np.float64),
            make_grid(pt, poly, dtype=torch.float64, device="cpu"))


@pytest.mark.parametrize("field", FLOAT_FIELDS)
def test_grid_field_matches_jax(grids, field):
    gj, gp = grids
    ref = np.asarray(getattr(gj, field))
    got = getattr(gp, field).numpy()
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= TOL * np.max(np.abs(ref))


def test_grid_tables_match_jax(grids):
    gj, gp = grids
    np.testing.assert_array_equal(gp.face_bctag.numpy(),
                                  np.asarray(gj.face_bctag))
    np.testing.assert_array_equal(gp.face_nbr_row.numpy(),
                                  np.asarray(gj.face_nbr_row))
    assert gp.face_perm_identity == gj.face_perm_identity
    assert (gp.n_horz, gp.n_vert) == (gj.n_horz, gj.n_vert)
    np.testing.assert_array_equal(gp.fmask_padded, gj.fmask_padded)


@pytest.mark.parametrize("direction", ["every", "horizontal", "vertical"])
def test_min_node_distance_matches_jax(grids, direction):
    gj, gp = grids
    ref = jax_min_node_distance(gj, direction)
    assert abs(min_node_distance(gp, direction) - ref) <= TOL * ref


@pytest.mark.parametrize("periodicity", [(True, True, True),
                                         (False, True, False)])
def test_brick_without_boundary_keeps_its_tables(periodicity):
    """The vortex's call (every side periodic) and a walled call without
    ``boundary``: the JAX package's default tags, 1 on every side that
    does not wrap."""
    ranges = [np.linspace(-1.0, 1.0, 5)] * 2 + [np.linspace(-1.0, 1.0, 2)]
    jt = jax_topology.brick_topology(ranges, periodicity)
    pt = topology.brick_topology(ranges, periodicity=periodicity)
    for key in TABLES:
        np.testing.assert_array_equal(getattr(pt, key), getattr(jt, key),
                                      err_msg=key)
    assert set(np.unique(pt.face_bctag)) <= {0, 1}
    assert pt.meshwarp is None and pt.stack is None
