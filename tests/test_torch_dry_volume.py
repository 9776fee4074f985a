"""The port's dry volume tendency (climatemachine_tpu_torch.dg
.dry_volume_kernel) against the JAX Pallas kernel ``dry_volume_tendency``
run in interpret mode, in float64 on the CPU, on seeded physically
scaled inputs, for ``subtract_ref`` on and off with ``lin_dims`` (), (2,)
with and without ``lin_gravity``:

- against the JAX kernel body with its weak-divergence dot at the
  inputs' precision: within 1e-12 of max|ref| per variable.  The JAX
  kernel asks its dot for float32 results (``preferred_element_type=
  jnp.float32``, pallas_volume.py:90-93), so under float64 it rounds
  the contraction to float32; the test swaps ``jax.lax.dot_general`` for
  one that keeps the inputs' precision while it runs the unjitted
  kernel, and nothing else of the JAX kernel changes;
- against the JAX kernel as it is, on the remainder's inputs: within
  1e-6 (float32 rounding of a contraction whose terms cancel to ~1e-2 of
  their size here; measured 3.5e-8 to 5.4e-8 over the cases above).

On a CPU tensor the wrapper is the plain version, bit for bit; the CUDA
kernel is held against the plain version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg import pallas_volume as jax_pallas_volume
from climatemachine_tpu_torch.dg.dry_volume_kernel import (
    dry_volume_tendency, dry_volume_tendency_plain)
from climatemachine_tpu_torch.physics.parameters import EARTH

E, NP = 32, 64
KW = dict(R_d=EARTH.R_d, cv_d=EARTH.cv_d, T_0=EARTH.T_0)
# (lin_dims, lin_gravity)
LIN = {"no_remainder": ((), True), "vertical_gravity": ((2,), True),
       "vertical_acoustic": ((2,), False)}


def _inputs(seed):
    """Var-major inputs: rho ~ 1, |u| <= 50, T in 200-300 K, phi up to
    30 km of geopotential, p_ref within 1e-3 of p."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.1 * rng.standard_normal((E, NP))
    u = rng.uniform(-50.0, 50.0, (E, 3, NP))
    phi = EARTH.grav * rng.uniform(0, 3e4, (E, NP))
    e_int = EARTH.cv_d * (rng.uniform(200.0, 300.0, (E, NP)) - EARTH.T_0)
    rhoe = rho * (e_int + 0.5 * np.sum(u * u, axis=1) + phi)
    qv = np.concatenate([rho[:, None], rho[:, None] * u, rhoe[:, None]],
                        axis=1)
    p = rho * EARTH.R_d * (EARTH.T_0 + e_int / EARTH.cv_d)
    p_ref = p * (1 + 1e-3 * rng.standard_normal((E, NP)))
    ref3 = np.stack([rho * (e_int + phi), rho, p_ref], axis=1)
    xiv = 1e-4 * rng.standard_normal((E, 9, NP))
    M = rng.uniform(1e9, 2e9, (E, NP))
    return (qv, phi, p_ref, ref3, xiv, M, 1.0 / M,
            rng.standard_normal((NP, 3 * NP)))


def _jax_kernel(args, kernel, **kw):
    """``kernel`` on the node-major form of the var-major ``args``; the
    tendency back var-major."""
    qv, phi, p_ref, ref3, xiv, M, MI, Wdiv = (jnp.asarray(a) for a in args)
    out = kernel(qv.transpose(0, 2, 1), phi, p_ref, ref3,
                 xiv.transpose(0, 2, 1), M, MI, Wdiv, interpret=True, **kw)
    return np.asarray(out).transpose(0, 2, 1)


def _rel_err(got, ref):
    scale = np.max(np.abs(ref), axis=(0, 2))
    return np.max(np.abs(got - ref), axis=(0, 2)) / scale


def _jax_kernel_full_precision(monkeypatch, args, **kw):
    """The unjitted JAX kernel with its dot at the inputs' precision."""
    dot_general = jax.lax.dot_general

    def dot_general_full(*a, **k):
        k["preferred_element_type"] = None
        return dot_general(*a, **k)

    monkeypatch.setattr(jax.lax, "dot_general", dot_general_full)
    try:
        return _jax_kernel(
            args, jax_pallas_volume.dry_volume_tendency.__wrapped__, **kw)
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("subtract_ref", [True, False],
                         ids=["subtract", "no_subtract"])
@pytest.mark.parametrize("lin", list(LIN))
def test_plain_dry_volume_matches_jax_kernel(monkeypatch, lin, subtract_ref):
    lin_dims, lin_gravity = LIN[lin]
    kw = dict(KW, subtract_ref=subtract_ref, lin_dims=lin_dims,
              lin_gravity=lin_gravity)
    args = _inputs(seed=len(lin) + subtract_ref)
    targs = [torch.as_tensor(a) for a in args]
    got = dry_volume_tendency_plain(*targs, **kw).numpy()
    assert got.shape == (E, 5, NP)
    err = _rel_err(got, _jax_kernel_full_precision(monkeypatch, args, **kw))
    assert err.max() < 1e-12, err
    # on CPU tensors the wrapper is the plain version, bit for bit
    np.testing.assert_array_equal(dry_volume_tendency(*targs, **kw).numpy(),
                                  got)


def test_jax_kernel_rounds_its_contraction_to_float32(monkeypatch):
    """The JAX kernel as it is, on the remainder's inputs: within 1e-6 of
    the plain version, and a thousand times further from it than the
    same kernel body with its dot at full precision."""
    kw = dict(KW, lin_dims=(2,), lin_gravity=True)
    args = _inputs(seed=3)
    got = dry_volume_tendency_plain(*(torch.as_tensor(a) for a in args),
                                    **kw).numpy()
    err32 = _rel_err(got, _jax_kernel(
        args, jax_pallas_volume.dry_volume_tendency, **kw))
    assert err32.max() < 1e-6, err32
    err = _rel_err(got, _jax_kernel_full_precision(monkeypatch, args, **kw))
    assert err32.max() > 1e3 * err.max()
