"""The ocean's grid, column and filter operations in the port against
the JAX package's, in float64 on the CPU (tests/ocean_parity.py: a
stacked 3 × 2 × 3 box at p3 with unevenly spaced layers), each within
1e-13 of the largest magnitude of the JAX result:

- the vertical line Jacobian ``JcV`` of the port's own ``make_grid``
  against the JAX grid's (and the element order of the stack);
- ``lagrange_antiderivative_matrix`` and the five ``ColumnOps``
  operations on a field from numpy seed 0, and on z² against the exact
  antiderivative;
- ``CutoffFilter`` and ``ExponentialFilter`` in the "vertical",
  "horizontal" and "every" directions; ``apply_vm`` against the JAX
  nodal operator.
"""

import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.columns import ColumnOps as JaxColumnOps
from climatemachine_tpu.dg.columns import \
    lagrange_antiderivative_matrix as jax_antiderivative
from climatemachine_tpu.mesh import filters as jfilters
from climatemachine_tpu_torch.dg.columns import (
    ColumnOps, lagrange_antiderivative_matrix)
from climatemachine_tpu_torch.mesh import filters
from climatemachine_tpu_torch.mesh.grid import make_grid
from climatemachine_tpu_torch.mesh.topology import stacked_brick_topology
from ocean_parity import grids, nm, ranges, vm

TOL = 1e-13
OPS = ("indefinite_integral", "reverse_indefinite_integral", "column_total",
       "broadcast_top", "broadcast_bottom")


@pytest.fixture(scope="module")
def grid_pair():
    return grids()


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def test_jcv_and_stack_order_of_make_grid(grid_pair):
    gj, _ = grid_pair
    topo = stacked_brick_topology(ranges(), periodicity=(False,) * 3,
                                  boundary=np.array([[1, 1], [1, 1], [2, 3]]))
    g = make_grid(topo, 3, dtype=torch.float64, device="cpu")
    assert (g.n_horz, g.n_vert) == (6, 3)
    assert _rel(g.coords.numpy(), gj.coords) < TOL
    assert _rel(g.JcV.numpy(), gj.JcV) < TOL
    # the layers' half thicknesses, column by column
    half = 0.5 * 400.0 * np.array([0.25, 0.45, 0.3])
    jcv = g.JcV.numpy().reshape(6, 3, -1)
    assert np.allclose(jcv, half[None, :, None], rtol=1e-13)


def test_antiderivative_matrix(grid_pair):
    gj, _ = grid_pair
    xi = np.asarray(gj.xi[2])
    np.testing.assert_array_equal(lagrange_antiderivative_matrix(xi),
                                  jax_antiderivative(xi))


@pytest.mark.parametrize("op", OPS)
def test_column_ops_match_jax(grid_pair, op):
    gj, gt = grid_pair
    f = np.random.default_rng(0).standard_normal((gt.nelem, gt.Np, 2))
    ref = getattr(JaxColumnOps(gj), op)(f)
    got = getattr(ColumnOps(gt), op)(vm(f))
    assert _rel(nm(got), ref) < TOL


def test_column_integrals_exact(grid_pair):
    """∫_b^z 3z′² dz′ = z³ + H³, and the reverse integral −z³."""
    _, gt = grid_pair
    z = gt.coords[..., 2][:, None]                      # [E, 1, Np]
    cols = ColumnOps(gt)
    H3 = 400.0 ** 3
    np.testing.assert_allclose(cols.indefinite_integral(3 * z ** 2),
                               z ** 3 + H3, rtol=0, atol=1e-13 * H3)
    np.testing.assert_allclose(cols.reverse_indefinite_integral(3 * z ** 2),
                               -z ** 3, rtol=0, atol=1e-13 * H3)
    np.testing.assert_allclose(cols.broadcast_top(z), 0 * z, atol=1e-12)
    np.testing.assert_allclose(cols.broadcast_bottom(z), 0 * z - 400.0,
                               rtol=1e-15)


FILTERS = {"cutoff": (lambda m, g: m.CutoffFilter(g, Nc=g.Nq[-1] - 2)),
           "cutoff_default": (lambda m, g: m.CutoffFilter(g)),
           "exponential": (lambda m, g: m.ExponentialFilter(g, Nc=1, s=8))}


@pytest.mark.parametrize("direction", ["vertical", "horizontal", "every"])
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filters_match_jax(grid_pair, name, direction):
    gj, gt = grid_pair
    q = np.random.default_rng(1).standard_normal((gt.nelem, gt.Np, 4))
    ref = FILTERS[name](jfilters, gj)(q, direction=direction)
    filt = FILTERS[name](filters, gt)
    assert _rel(nm(filt(vm(q), direction=direction)), ref) < TOL
    np.testing.assert_allclose(
        filt.nodal_matrix(direction),
        FILTERS[name](jfilters, gj).nodal_matrix(direction), rtol=0,
        atol=1e-14)


def test_apply_vm_is_every_direction(grid_pair):
    _, gt = grid_pair
    q = vm(np.random.default_rng(2).standard_normal((gt.nelem, gt.Np, 3)))
    filt = filters.ExponentialFilter(gt, 0, 16)
    assert torch.allclose(filt.apply_vm(q), filt(q, "every"), rtol=0,
                          atol=1e-13 * q.abs().max().item())
