"""Matrix-free Krylov solvers (port of
``climatemachine_tpu/solvers/iterative.py`` ``gmres`` :28-70 and
``batched_gmres`` :72-122): restarted GMRES with the least-squares solve
on the Hessenberg matrix, without the JAX functions' initial guess and
preconditioner, which no caller passes.  ``gmres`` orthogonalises by
modified Gram-Schmidt on one flat system; ``batched_gmres`` carries a
batch axis natively, as the JAX function does (one classical
Gram-Schmidt contraction a step over every system).  Conjugate
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


def _batched_lstsq_min_norm(H: torch.Tensor, beta: torch.Tensor
                            ) -> torch.Tensor:
    """Each system's argmin ‖β_b e₁ − H_b y‖ of minimum norm, as
    :func:`_lstsq_min_norm`, for H ``[B, k + 1, k]`` and β ``[B]``: one
    copy to the host a cycle.  Returns y ``[B, k]`` on H's device."""
    Hh = H.detach().cpu().to(torch.float64).numpy()
    bh = beta.detach().cpu().to(torch.float64).numpy()
    y = np.empty(Hh.shape[::2])
    for i, (Hi, bi) in enumerate(zip(Hh, bh)):
        e1 = np.zeros(Hi.shape[0])
        e1[0] = bi
        y[i] = np.linalg.lstsq(Hi, e1, rcond=None)[0]
    return torch.as_tensor(y, dtype=H.dtype, device=H.device)


def batched_gmres(op: Callable, b, n_krylov: int = 20, restarts: int = 1):
    """Restarted GMRES for B systems at once: ``op`` maps the whole batch
    ``[B, n]`` to ``[B, n]``, each row through its own system (it must
    see the full batch: its coefficients may differ per row).  Every
    Arnoldi step is one application of ``op`` and one masked classical
    Gram-Schmidt contraction over the batch; the least squares runs per
    system on the host.  Returns (x ``[B, n]``, ‖op(x) − b‖ per system,
    ``[B]`` on b's device)."""
    B, n = b.shape
    one = torch.ones((), dtype=b.dtype, device=b.device)
    mask = torch.arange(n_krylov + 1, device=b.device)

    def cycle(x):
        r = b - op(x)
        beta = torch.linalg.vector_norm(r, dim=1)
        V = b.new_zeros((n_krylov + 1, B, n))
        V[0] = r / torch.where(beta == 0, one, beta)[:, None]
        H = b.new_zeros((B, n_krylov + 1, n_krylov))
        for j in range(n_krylov):
            w = op(V[j])
            h = torch.einsum("kbn,bn->bk", V, w)
            h = torch.where((mask <= j)[None, :], h, 0.0)
            w = w - torch.einsum("bk,kbn->bn", h, V)
            hn = torch.linalg.vector_norm(w, dim=1)
            V[j + 1] = w / torch.where(hn == 0, one, hn)[:, None]
            h[:, j + 1] = hn
            H[:, :, j] = h
        y = _batched_lstsq_min_norm(H, beta)
        return x + torch.einsum("bk,kbn->bn", y, V[:n_krylov])

    x = torch.zeros_like(b)
    for _ in range(restarts):
        x = cycle(x)
    return x, torch.linalg.vector_norm(op(x) - b, dim=1)
