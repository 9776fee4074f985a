"""The PyTorch port's grid build (climatemachine_tpu_torch.mesh) against
the JAX package's, in float64 on the CPU: metrics, mass, normals, face
weights, lift, the weak-divergence and gradient operators and the
filter's nodal matrix within 1e-12 relative; neighbour and boundary
tables and the face node masks exactly."""

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


def test_min_node_distance_matches_jax(grids):
    g_jax, g_torch = grids
    ref = jax_min_node_distance(g_jax)
    assert abs(min_node_distance(g_torch) - ref) <= 1e-12 * ref


def test_filter_nodal_matrix_matches_jax(grids):
    g_jax, g_torch = grids
    ref = JaxExponentialFilter(g_jax, 0, 20).nodal_matrix()
    filt = ExponentialFilter(g_torch, 0, 20)
    assert _rel_err(filt.nodal_matrix(), ref) < 1e-12
    assert _rel_err(filt.nodal.numpy(), ref) < 1e-12
