"""GMRES (solvers/iterative.py) in the port against the JAX package's, in
float64 on the CPU: on the dense systems of
tests/test_iterative_solvers.py:15-33 (n = 30 with 30 Krylov vectors;
n = 40 with 15 vectors and 4 restarts) within 1e-12 of the JAX
solution's largest magnitude, with its residual; and on operators whose
Krylov space breaks down: the identity on e₁ (H rank 1, the rest of it
exactly 0) and 2.5·I on a random vector, where both packages'
minimum-norm least squares give b/2.5 to round-off.  (The JAX function
runs eagerly: jitted it compiles for longer than it runs.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.solvers.iterative import gmres as jax_gmres
from climatemachine_tpu_torch.solvers.iterative import gmres


def _dense(seed, n, scale):
    rng = np.random.RandomState(seed)
    A = np.eye(n) + scale * rng.randn(n, n)
    return A, rng.randn(n)


SYSTEMS = {
    # tests/test_iterative_solvers.py:15-33
    "dense_n30": (lambda: _dense(0, 30, 0.1), dict(n_krylov=30)),
    "restarted_n40": (lambda: _dense(1, 40, 0.3 / np.sqrt(40)),
                      dict(n_krylov=15, restarts=4)),
    "identity_breakdown": (lambda: (np.eye(12), np.eye(12)[0]),
                           dict(n_krylov=4, restarts=1)),
    "scaled_identity": (lambda: (2.5 * np.eye(20),
                                 np.random.RandomState(3).randn(20)),
                        dict(n_krylov=4, restarts=2)),
}


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_gmres_against_jax(name):
    make, kw = SYSTEMS[name]
    A, b = make()
    xj, rj = jax_gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), **kw)
    At = torch.tensor(A)
    xt, rt = gmres(lambda v: At @ v, torch.tensor(b), **kw)
    xj = np.asarray(xj)
    assert np.isfinite(xt.numpy()).all()
    assert np.abs(xt.numpy() - xj).max() <= 1e-12 * np.abs(xj).max()
    assert float(rt) <= max(10 * float(rj), 1e-13 * np.linalg.norm(b))
    np.testing.assert_allclose(xt.numpy(), np.linalg.solve(A, b),
                               atol=1e-6 * np.abs(xj).max())
