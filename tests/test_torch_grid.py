"""The PyTorch port's grid build (climatemachine_tpu_torch.mesh) against
the JAX package's, in float64 on the CPU: metrics, mass, normals, face
weights, lift, the weak-divergence and gradient operators, the
filter's nodal matrix and the minimum node distance in each direction
within 1e-12 relative; neighbour and boundary tables, the face node
masks and the stack dims exactly."""

import numpy as np
import pytest
import torch

from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu.mesh.filters import \
    ExponentialFilter as JaxExponentialFilter
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu_torch.experiments.held_suarez import (
    held_suarez_config)
from climatemachine_tpu_torch.interop import grid_from_numpy, grid_to_numpy
from climatemachine_tpu_torch.mesh.filters import ExponentialFilter
from climatemachine_tpu_torch.mesh.grid import min_node_distance

FLOAT_FIELDS = ("coords", "J", "M", "MI", "xi_x", "normals", "sM", "lift",
                "Wdiv", "Wgrad")
SIZES = [(2, 2, 3), (3, 2, 4)]       # (n_horz, n_vert, poly_order)


@pytest.fixture(scope="module", params=SIZES,
                ids=[f"h{h}v{v}p{p}" for h, v, p in SIZES])
def grids(request):
    n_horz, n_vert, poly = request.param
    g_jax = jax_held_suarez_config(n_horz, n_vert, poly, dtype=np.float64,
                                   hyperdiffusion_tau=None).grid
    g_torch = held_suarez_config(n_horz, n_vert, poly, dtype=torch.float64,
                                 hyperdiffusion_tau=None, device="cpu").grid
    return g_jax, g_torch


def _rel_err(got, ref):
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(np.asarray(got) - ref)) / max(np.max(np.abs(ref)),
                                                       1e-300)


@pytest.mark.parametrize("name", FLOAT_FIELDS)
def test_grid_field_matches_jax(grids, name):
    g_jax, g_torch = grids
    got = getattr(g_torch, name)
    ref = np.asarray(getattr(g_jax, name))
    assert got.dtype == torch.float64
    assert tuple(got.shape) == ref.shape
    assert _rel_err(got.numpy(), ref) < 1e-12


def test_grid_tables_match_jax(grids):
    g_jax, g_torch = grids
    assert (g_torch.Nq, g_torch.Np, g_torch.Nfp_max) == \
        (tuple(g_jax.Nq), g_jax.Np, g_jax.Nfp_max)
    np.testing.assert_array_equal(g_torch.face_nbr_row.numpy(),
                                  np.asarray(g_jax.face_nbr_row))
    np.testing.assert_array_equal(g_torch.face_bctag.numpy(),
                                  np.asarray(g_jax.face_bctag))
    assert g_torch.face_perm_identity is bool(g_jax.face_perm_identity)
    assert g_torch.face_perm_identity


def test_fmask_padded_matches_jax(grids):
    g_jax, g_torch = grids
    assert isinstance(g_torch.fmask_padded, np.ndarray)
    np.testing.assert_array_equal(g_torch.fmask_padded,
                                  np.asarray(g_jax.fmask_padded))


@pytest.mark.parametrize("direction", [None, "every", "horizontal",
                                       "vertical"])
def test_min_node_distance_matches_jax(grids, direction):
    g_jax, g_torch = grids
    args = () if direction is None else (direction,)
    ref = jax_min_node_distance(g_jax, *args)
    assert abs(min_node_distance(g_torch, *args) - ref) <= 1e-12 * ref


def test_stack_dims_match_jax(grids):
    """n_horz (horizontal elements) and n_vert, from the topology and
    through interop."""
    g_jax, g_torch = grids
    assert (g_torch.n_horz, g_torch.n_vert) == (g_jax.n_horz, g_jax.n_vert)
    assert g_torch.n_horz * g_torch.n_vert == g_torch.nelem
    back = grid_from_numpy(grid_to_numpy(g_jax), device="cpu",
                           dtype=torch.float64)
    assert (back.n_horz, back.n_vert) == (g_jax.n_horz, g_jax.n_vert)


def test_filter_nodal_matrix_matches_jax(grids):
    g_jax, g_torch = grids
    ref = JaxExponentialFilter(g_jax, 0, 20).nodal_matrix()
    filt = ExponentialFilter(g_torch, 0, 20)
    assert _rel_err(filt.nodal_matrix(), ref) < 1e-12
    assert _rel_err(filt.nodal.numpy(), ref) < 1e-12
