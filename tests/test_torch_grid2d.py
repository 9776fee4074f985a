"""The port's 2-D brick and grid (mesh/topology.py, mesh/metrics.py
``geometry_2d``, mesh/grid.py at ``dim`` 2) against the JAX package's,
in float64 on the CPU, on a 3 × 2 brick over [0, 1e6] × [0, 7e5] with
stretched x interfaces, at p3 and p4, periodic and walled (tags 1-4 on
the four sides): every float field within 1e-13 of the JAX field's
largest magnitude, the topology's tables, the face node masks, the
boundary tags and neighbour rows exactly, the minimum node distance in
each direction; the grid carried across by interop.py with its ``dim``;
the stacked brick's horizontal element and node order is the 2-D
brick's (the split-explicit coupling's layout).
"""

import numpy as np
import pytest
import torch

from climatemachine_tpu.mesh.grid import make_grid as jax_make_grid
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu.mesh.topology import \
    brick_topology as jax_brick_topology
from climatemachine_tpu_torch.dg.columns import ColumnOps
from climatemachine_tpu_torch.interop import grid_from_numpy, grid_to_numpy
from climatemachine_tpu_torch.mesh.grid import make_grid, min_node_distance
from climatemachine_tpu_torch.mesh.topology import (brick_topology,
                                                    stacked_brick_topology)

TOL = 1e-13
RANGES = [np.array([0.0, 2.5e5, 6e5, 1e6]), np.linspace(0.0, 7e5, 3)]
WALLS = np.array([[1, 2], [3, 4]])
FLOAT_FIELDS = ("coords", "M", "MI", "J", "JcV", "xi_x", "normals", "sM",
                "lift", "Wdiv", "Wgrad")
EXACT_FIELDS = ("face_bctag", "face_nbr_row", "fmask_padded")
TOPO_FIELDS = ("elem_to_coord", "face_neighbor", "face_neighbor_face",
               "face_orient", "face_bctag")
CONFIGS = [(p, per) for p in (3, 4) for per in (False, True)]


def _topologies(periodic):
    kw = dict(periodicity=(periodic,) * 2,
              boundary=None if periodic else WALLS)
    return jax_brick_topology(RANGES, **kw), brick_topology(RANGES, **kw)


@pytest.fixture(scope="module", params=CONFIGS,
                ids=[f"p{p}-{'periodic' if per else 'walled'}"
                     for p, per in CONFIGS])
def grids(request):
    poly, periodic = request.param
    tj, tt = _topologies(periodic)
    return (jax_make_grid(tj, poly, dtype=np.float64),
            make_grid(tt, poly, dtype=torch.float64, device="cpu"))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("field", TOPO_FIELDS)
def test_topology(field, periodic):
    tj, tt = _topologies(periodic)
    assert tt.dim == tj.dim == 2
    np.testing.assert_array_equal(getattr(tt, field), getattr(tj, field))


@pytest.mark.parametrize("field", FLOAT_FIELDS)
def test_float_field(grids, field):
    gj, gt = grids
    ref = np.asarray(getattr(gj, field))
    got = getattr(gt, field).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


@pytest.mark.parametrize("field", EXACT_FIELDS)
def test_exact_field(grids, field):
    gj, gt = grids
    got = getattr(gt, field)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(getattr(gj, field)))


def test_dims(grids):
    gj, gt = grids
    assert (gt.dim, gt.nface, gt.Nq, gt.Np, gt.Nfp, gt.Nfp_max) == (
        gj.dim, gj.nface, gj.Nq, gj.Np, gj.Nfp, gj.Nfp_max)
    assert gt.face_perm_identity and gt.n_vert is None


@pytest.mark.parametrize("direction", ["every", "horizontal", "vertical"])
def test_min_node_distance(grids, direction):
    gj, gt = grids
    assert min_node_distance(gt, direction) == pytest.approx(
        jax_min_node_distance(gj, direction), rel=1e-14)


def test_interop_round_trip(grids):
    """grid_from_numpy takes the JAX 2-D grid's fields, ``dim`` among
    them, and gives the port's own 2-D grid."""
    gj, gt = grids
    fields = grid_to_numpy(gj)
    assert fields["dim"] == 2
    gc = grid_from_numpy(fields, device="cpu", dtype=torch.float64)
    assert (gc.dim, gc.nface, gc.Nfp) == (2, 4, gt.Nfp)
    for name in FLOAT_FIELDS:
        assert torch.allclose(getattr(gc, name), getattr(gt, name),
                              rtol=0, atol=TOL * getattr(
                                  gt, name).abs().max().item())
    with pytest.raises(ValueError):
        grid_from_numpy(dict(fields, dim=3), device="cpu")


def test_stack_horizontal_order_is_the_2d_brick():
    """The stacked brick's top layer in the 2-D layout of ColumnOps is
    the 2-D brick's coordinates, element and node for element and node,
    on a 3 × 2 × 2 box (nx ≠ ny)."""
    z = np.array([-400.0, -150.0, 0.0])
    g3 = make_grid(stacked_brick_topology(RANGES + [z]), 3,
                   dtype=torch.float64, device="cpu")
    g2 = make_grid(brick_topology(RANGES), 3, dtype=torch.float64,
                   device="cpu")
    cols = ColumnOps(g3)
    xy = cols.to_stack(g3.coords.transpose(1, 2)[:, :2])[:, 0, :, 0, :]
    assert torch.equal(xy, g2.coords.transpose(1, 2))
