"""The port's ``SingleStackConfiguration`` against the JAX package's:
the grid (element count, ``n_vert``, coordinates, face tags) as
tests/test_driver.py's ``test_single_stack_configuration`` checks it.
The BOMEX single stack through it is in
test_torch_bomex_single_stack.py."""

import numpy as np
import pytest
import torch

from climatemachine_tpu import driver_api as jcm
from climatemachine_tpu_torch import driver_api as cm
from forced_les_parity import jax_bomex


@pytest.mark.parametrize("nelem, zmax, hmax, poly",
                         [(5, 1000.0, 1.0, 3), (4, 3000.0, 100.0, 4)])
def test_grid_matches_jax(nelem, zmax, hmax, poly):
    jdc = jcm.SingleStackConfiguration("stack", poly, nelem, zmax,
                                       jax_bomex("prescribed"), hmax=hmax,
                                       dtype=np.float64)
    dc = cm.SingleStackConfiguration("stack", poly, nelem, zmax, None,
                                     hmax=hmax, dtype=torch.float64,
                                     device="cpu")
    g, jg = dc.grid, jdc.grid
    assert g.nelem == jg.nelem == nelem
    assert g.n_vert == jg.n_vert == nelem
    np.testing.assert_array_equal(g.face_bctag.numpy(),
                                  np.asarray(jg.face_bctag))
    np.testing.assert_allclose(g.coords.numpy(), np.asarray(jg.coords),
                               rtol=0, atol=1e-12 * zmax)
    z = g.coords[..., 2]
    assert abs(float(z.min())) <= 1e-12 * zmax
    assert abs(float(z.max()) - zmax) <= 1e-12 * zmax
    assert abs(float(g.coords[..., 0].max()) - hmax) <= 1e-12 * hmax
    assert dc.config_info == jdc.config_info
