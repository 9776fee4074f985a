"""The port's fused volume tendency (climatemachine_tpu_torch.dg
.volume_kernel) against the JAX Pallas kernel run in interpret mode, in
float64 on the CPU, within 1e-12 relative.  On a CPU tensor the wrapper
runs the plain PyTorch version; the CUDA kernel itself is held against
that plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.pallas_volume import \
    fused_volume_tendency_vm as jax_fused_volume_tendency_vm
from climatemachine_tpu_torch.dg.volume_kernel import (
    fused_volume_tendency_vm, volume_tendency_plain)
from climatemachine_tpu_torch.physics.parameters import EARTH

E, NP = 32, 64

# (nq, ngl, subtract_ref, has_f2, lin_dims, lin_gravity)
CASES = {
    "main_path": (5, 1, True, False, (), True),
    "no_subtract": (5, 1, False, False, (), True),
    "has_f2": (5, 4, True, True, (), True),
    "lin_vertical": (5, 1, True, False, (2,), True),
    "lin_every_acoustic": (5, 1, True, False, (0, 1, 2), False),
    "moist_f2_lin": (6, 5, True, True, (2,), True),
}


def _inputs(nq, ngl, seed):
    """Physically scaled random inputs: rho ~ 1, |u| <= 50, p ~ 1e5."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.1 * rng.standard_normal((E, NP))
    u = rng.uniform(-50.0, 50.0, (E, 3, NP))
    rhoe = rho * (2.5e5 + 1e4 * rng.standard_normal((E, NP)))
    extra = [rho[:, None] * 1e-3 * rng.uniform(0, 5, (E, 1, NP))] * (nq - 5)
    qv = np.concatenate([rho[:, None], rho[:, None] * u, rhoe[:, None]]
                        + extra, axis=1)
    p = 1e5 * (1 + 0.05 * rng.standard_normal((E, NP)))
    p_ref = p * (1 + 1e-3 * rng.standard_normal((E, NP)))
    phi = 9.81 * rng.uniform(0, 3e4, (E, NP))
    ref3 = np.stack([2.5e5 * rho, rho, p_ref], axis=1)
    gl2 = 1e-12 * rng.standard_normal((E, 3 * ngl, NP))
    nu = 1e14 * rng.uniform(0.5, 1.5, (E, 2, NP))
    xiv = 1e-4 * rng.standard_normal((E, 9, NP))
    M = rng.uniform(1e9, 2e9, (E, NP))
    MI = 1.0 / M
    Wdiv = rng.standard_normal((NP, 3 * NP))
    return (qv, p, phi, p_ref, ref3, gl2, nu, xiv, M, MI, Wdiv)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_volume_matches_jax_kernel(case):
    nq, ngl, subtract_ref, has_f2, lin_dims, lin_gravity = CASES[case]
    args = _inputs(nq, ngl, seed=len(case))
    kw = dict(nq=nq, ngl=ngl, R_d=EARTH.R_d, cv_d=EARTH.cv_d, T_0=EARTH.T_0,
              subtract_ref=subtract_ref, has_f2=has_f2, lin_dims=lin_dims,
              lin_gravity=lin_gravity)
    ref = np.asarray(jax_fused_volume_tendency_vm(
        *(jnp.asarray(a) for a in args), interpret=True, **kw))
    targs = [torch.as_tensor(a) for a in args]
    got = volume_tendency_plain(*targs, **kw).numpy()
    assert got.shape == ref.shape == (E, nq, NP)
    scale = np.max(np.abs(ref), axis=(0, 2))
    err = np.max(np.abs(got - ref), axis=(0, 2)) / scale
    assert err.max() < 1e-12, err
    # on CPU tensors the wrapper is the plain version, bit for bit
    wrapped = fused_volume_tendency_vm(*targs, **kw).numpy()
    np.testing.assert_array_equal(wrapped, got)
