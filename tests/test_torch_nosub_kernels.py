"""The plain versions of the var-major volume kernel's branches without
the reference pressure taken out, against the JAX Pallas kernel run in
interpret mode, in float64 on the CPU: ``fused_volume_tendency_vm`` with
``subtract_ref=False`` at nq = 5 and 6, with and without F₂, without a
remainder and with ``lin_dims`` (2,) and (0, 1, 2), and with ``lin_dims``
(0, 1) and p_ref subtracted (the dry kernel's case holds (0, 1) without
it), on the seeded, physically
scaled inputs of tests/test_torch_remainder_kernels.py: 1e-12 of
max|ref| per variable.  The dry volume kernel and the surface kernels
are held the same way in tests/test_torch_nosub_dry_surface.py.

Each case also checks that the branch differs from the one with the
other ``subtract_ref``, and that the wrapper on a CPU tensor (without
p_ref where it is not read) is its plain version bit for bit; the CUDA
kernels are held against the plain versions on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg import pallas_volume as jax_pallas_volume
from climatemachine_tpu_torch.dg import volume_kernel
from test_torch_remainder_kernels import KW, TOL, _rel_err, _volume_inputs

E = 32


# --- the var-major volume kernel --------------------------------------------------

# (nq, has_f2, lin_dims, lin_gravity, subtract_ref)
VOLUME = {"nq5": (5, False, (), True, False),
          "nq6-f2": (6, True, (), True, False),
          "nq6-vertical-acoustic": (6, False, (2,), False, False),
          "nq5-f2-every-gravity": (5, True, (0, 1, 2), True, False),
          "nq6-horizontal-acoustic-subtract": (6, False, (0, 1), False,
                                               True)}


@pytest.mark.parametrize("case", list(VOLUME))
def test_volume_nosub_matches_jax_kernel(case):
    nq, has_f2, lin_dims, lin_gravity, subtract = VOLUME[case]
    ngl = nq - 1 if has_f2 else 1
    x = _volume_inputs(nq, ngl, seed=81 + list(VOLUME).index(case))
    args = [x[k] for k in ("qv", "p", "phi", "p_ref", "ref3", "gl2", "nu",
                           "xiv", "M", "MI", "Wdiv")]
    kw = dict(KW, nq=nq, ngl=ngl, subtract_ref=subtract, has_f2=has_f2,
              lin_dims=lin_dims, lin_gravity=lin_gravity)
    ref = jax_pallas_volume.fused_volume_tendency_vm(
        *(jnp.asarray(a) for a in args), block_e=E, interpret=True, **kw)
    targs = [torch.as_tensor(a) for a in args]
    got = volume_kernel.volume_tendency_plain(*targs, **kw)
    err = _rel_err(got, ref)
    assert err.max() < TOL, err
    if not subtract:
        targs[3] = None               # p_ref is not read
    np.testing.assert_array_equal(
        volume_kernel.fused_volume_tendency_vm(*targs, **kw).numpy(),
        got.numpy())
    other = volume_kernel.volume_tendency_plain(
        *[torch.as_tensor(a) for a in args],
        **dict(kw, subtract_ref=not subtract))
    assert _rel_err(other, got).max() > 1e-6
