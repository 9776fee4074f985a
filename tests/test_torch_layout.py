"""The layout kernels' plain versions against the JAX Pallas layout
kernels (interpret mode) at layout dims given directly, not through a
grid: the shapes at which ``chip_smoke.py`` also holds the CUDA kernels
bit for bit against these plain versions, besides the bench's.

- (24, 3, 5, 5, 25): the small IMEX grid (n_horz=2, n_vert=3, p4);
- (37, 2, 5, 5, 25): an odd Eh, which leaves the kernels a tail tile of
  5 eh (their tile is 8) and, Eh·ji not being a multiple of 4, a scalar
  y side;
- (96, 4, 5, 4, 16): a p3 shape (Nq3 = 4, ji = 16).

A permutation rounds nothing, so both directions equal JAX exactly and
the round trip is exact; on CPU tensors the wrappers take the plain
versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.solvers.pallas_layout import (
    from_blocks_vm as jax_from_blocks_vm, to_blocks_vm as jax_to_blocks_vm)
from climatemachine_tpu_torch.solvers import layout_kernel


@pytest.mark.parametrize("dims", [(24, 3, 5, 5, 25), (37, 2, 5, 5, 25),
                                  (96, 4, 5, 4, 16)])
def test_layout_plain_matches_jax_at_edge_shapes(dims):
    Eh, nv, nvars, Nq3, ji = dims
    rng = np.random.default_rng(Eh)
    x = rng.standard_normal((Eh * nv, nvars, Nq3 * ji)).astype(np.float32)
    y = rng.standard_normal((nv, Nq3 * nvars, Eh * ji)).astype(np.float32)

    got_y = layout_kernel.to_blocks_vm_plain(torch.tensor(x), dims)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(
        jax_to_blocks_vm(jnp.asarray(x), layout_dims=dims, interpret=True)))
    got_x = layout_kernel.from_blocks_vm_plain(torch.tensor(y), dims)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(
        jax_from_blocks_vm(jnp.asarray(y), layout_dims=dims,
                           interpret=True)))

    assert torch.equal(layout_kernel.to_blocks_vm(torch.tensor(x), dims),
                       got_y)
    assert torch.equal(layout_kernel.from_blocks_vm(torch.tensor(y), dims),
                       got_x)
    assert torch.equal(layout_kernel.from_blocks_vm_plain(got_y, dims),
                       torch.tensor(x))
    assert torch.equal(layout_kernel.to_blocks_vm_plain(got_x, dims),
                       torch.tensor(y))
