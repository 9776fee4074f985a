"""Matrix-free Krylov solver (port of
``climatemachine_tpu/solvers/iterative.py`` ``gmres`` :28-70): restarted
GMRES with modified Gram-Schmidt and the least-squares solve on the
Hessenberg matrix, without the JAX function's initial guess and
preconditioner, which no caller passes.  ``batched_gmres``, conjugate
gradients, Newton-Krylov and GCR are not ported yet.

Fixed iteration counts, as the JAX package's: every cycle runs
``n_krylov`` Arnoldi steps, with no early exit, so nothing in the
Gram-Schmidt loop waits for the device.  The caller reads the returned
residual when it wants it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _lstsq_min_norm(H: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """argmin ‖β e₁ − H y‖ of minimum norm, on H's device.

    ``jnp.linalg.lstsq`` returns the minimum-norm solution through an SVD
    whose singular values below eps · max(m, n) · σ_max count as zero,
    rank-deficient H included: an Arnoldi breakdown (an operator that is
    a multiple of the identity on the Krylov space) leaves zero columns.
    ``torch.linalg.lstsq`` on CUDA has only the full-rank QR driver
    ``gels``, so the (n_krylov + 1) × n_krylov system goes to the host in
    float64 and numpy's ``lstsq`` (LAPACK ``gelsd``, the SVD, with that
    default cutoff) solves it: one small copy and one wait a cycle."""
    Hh = H.detach().cpu().to(torch.float64).numpy()
    e1 = np.zeros(Hh.shape[0])
    e1[0] = float(beta)
    y = np.linalg.lstsq(Hh, e1, rcond=None)[0]
    return torch.as_tensor(y, dtype=H.dtype, device=H.device)


def _cycle(A: Callable, b, x, n_krylov: int):
    """One GMRES cycle from x: ``n_krylov`` Arnoldi steps (modified
    Gram-Schmidt), then x + V y with y the least-squares solution."""
    r = b - A(x)
    beta = torch.linalg.vector_norm(r)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    V = [r / torch.where(beta == 0, one, beta)]
    H = b.new_zeros((n_krylov + 1, n_krylov))
    for j in range(n_krylov):
        w = A(V[j])
        col = []
        for i in range(j + 1):
            hij = torch.dot(V[i], w)
            col.append(hij)
            w = w - hij * V[i]
        hn = torch.linalg.vector_norm(w)
        col.append(hn)
        H[:j + 2, j] = torch.stack(col)
        V.append(w / torch.where(hn == 0, one, hn))
    y = _lstsq_min_norm(H, beta)
    return x + torch.stack(V[:n_krylov]).T @ y


def gmres(op: Callable, b, n_krylov: int = 20, restarts: int = 1):
    """Restarted GMRES for op(x) = b on flat vectors: ``restarts`` cycles
    of ``n_krylov`` steps from x = 0.  Returns (x, ‖b − op(x)‖ as a 0-d
    tensor on b's device)."""
    b = b.reshape(-1)
    x = torch.zeros_like(b)
    for _ in range(restarts):
        x = _cycle(op, b, x, n_krylov)
    return x, torch.linalg.vector_norm(b - op(x))
