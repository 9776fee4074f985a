"""Matrix-free iterative solvers (port of
``climatemachine_tpu/solvers/iterative.py``: ``gmres`` :28-70,
``batched_gmres`` :72-122, ``conjugate_gradient`` :125, ``newton_krylov``
:146, ``NoPreconditioner`` :170, ``ColumnwiseLUPreconditioner`` :175 and
``generalized_conjugate_residual`` :190).

Restarted GMRES with the least-squares solve on the Hessenberg matrix:
``gmres`` orthogonalises by modified Gram-Schmidt on one flat system,
with an initial guess and a right preconditioner; ``batched_gmres``
carries a batch axis natively, as the JAX function does (one classical
Gram-Schmidt contraction a step over every system).  CG for symmetric
positive definite operators, GCR(k) for general ones, and Jacobian-free
Newton-Krylov (J·v by a forward difference, each Newton step a GMRES
cycle).

Fixed iteration counts, as the JAX package's: every cycle runs
``n_krylov`` Arnoldi (CG, GCR) steps, with no early exit, and norms and
step sizes stay on the device, so nothing in those loops waits for it;
GMRES copies its small least-squares system to the host once a cycle.
The caller reads the returned residual when it wants it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _lstsq_min_norm(H: torch.Tensor, beta: torch.Tensor,
                    nonfinite_nan: bool = False):
    """argmin ‖β e₁ − H y‖ of minimum norm, on H's device.

    ``jnp.linalg.lstsq`` returns the minimum-norm solution through an SVD
    whose singular values below eps · max(m, n) · σ_max count as zero,
    rank-deficient H included: an Arnoldi breakdown (an operator that is
    a multiple of the identity on the Krylov space) leaves zero columns.
    ``torch.linalg.lstsq`` on CUDA has only the full-rank QR driver
    ``gels``, so the (n_krylov + 1) × n_krylov system goes to the host in
    float64 and numpy's ``lstsq`` (LAPACK ``gelsd``, the SVD, with that
    default cutoff) solves it: one small copy and one wait a cycle.
    A non-finite system raises (numpy's SVD does not converge), unless
    ``nonfinite_nan``: then y is NaN, as the JAX lstsq gives, and the
    state goes on non-finite (Newton-Krylov, whose caller reads the
    residual).  Returns (y on H's device, ‖β e₁ − H y‖ as a float: the
    cycle's residual in exact arithmetic)."""
    Hh = H.detach().cpu().to(torch.float64).numpy()
    e1 = np.zeros(Hh.shape[0])
    e1[0] = float(beta)
    if nonfinite_nan and not (np.isfinite(Hh).all()
                              and np.isfinite(e1).all()):
        y = np.full(Hh.shape[1], np.nan)
    else:
        y = np.linalg.lstsq(Hh, e1, rcond=None)[0]
    return (torch.as_tensor(y, dtype=H.dtype, device=H.device),
            float(np.linalg.norm(e1 - Hh @ y)))


def _cycle(A: Callable, b, x, n_krylov: int, r=None,
           nonfinite_nan: bool = False):
    """One GMRES cycle from x (its residual ``r`` = b − A(x) where the
    caller knows it): ``n_krylov`` Arnoldi steps (modified Gram-Schmidt),
    then x + V y with y the least-squares solution (``nonfinite_nan`` as
    :func:`_lstsq_min_norm`).  Returns (x + V y, the least-squares
    residual)."""
    if r is None:
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
    y, lsq = _lstsq_min_norm(H, beta, nonfinite_nan)
    return x + torch.stack(V[:n_krylov]).T @ y, lsq


def gmres(op: Callable, b, x0=None, n_krylov: int = 20, restarts: int = 1,
          precond: Optional[Callable] = None):
    """Restarted GMRES for op(x) = b on flat vectors: ``restarts`` cycles
    of ``n_krylov`` steps from ``x0`` (0 if not given).  ``precond`` is a
    right preconditioner M⁻¹: op(M⁻¹ y) = b is solved for y, starting
    from y = x0, and x = M⁻¹ y returned.  Returns (x, ‖b − op(x)‖ as a
    0-d tensor on b's device)."""
    b = b.reshape(-1)
    M = precond or (lambda v: v)

    def A(v):
        return op(M(v)).reshape(-1)

    x = torch.zeros_like(b) if x0 is None else x0.reshape(-1)
    for _ in range(restarts):
        x, _ = _cycle(A, b, x, n_krylov)
    return M(x), torch.linalg.vector_norm(b - A(x))


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


def conjugate_gradient(op: Callable, b, x0=None, n_iter: int = 50):
    """``n_iter`` conjugate-gradient steps for op(x) = b with op symmetric
    positive definite, from ``x0`` (0 if not given), on flat vectors.
    Returns (x, ‖b − op(x)‖ as a 0-d tensor)."""
    b = b.reshape(-1)
    x = torch.zeros_like(b) if x0 is None else x0.reshape(-1)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    r = b - op(x).reshape(-1)
    p = r
    rs = torch.dot(r, r)
    for _ in range(n_iter):
        Ap = op(p).reshape(-1)
        denom = torch.dot(p, Ap)
        alpha = rs / torch.where(denom == 0, one, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / torch.where(rs == 0, one, rs)) * p
        rs = rs_new
    return x, torch.linalg.vector_norm(b - op(x).reshape(-1))


def newton_krylov(F: Callable, x0, n_newton: int = 5, n_krylov: int = 20,
                  fd_eps: float = 1e-7, record: Optional[list] = None):
    """Jacobian-free Newton-Krylov for F(x) = 0 from ``x0``: ``n_newton``
    steps x += dx, each dx one GMRES cycle of ``n_krylov`` steps from 0
    for J·dx = −F(x), with J·v ≈ (F(x + εv) − F(x))/ε and ε = ``fd_eps`` ·
    (‖x‖ + 1)/‖v‖.  Every Newton step evaluates F 1 + ``n_krylov`` times
    (the JAX function's product J·0, exactly 0, is not evaluated, nor its
    GMRES residual, which it drops), and one more gives the residual.
    ``record``, a list, gets each Newton step's GMRES least-squares
    residual (a float; the cycle copies its system to the host anyway).
    Returns (x shaped as x0, ‖F(x)‖ as a 0-d tensor)."""
    shape = x0.shape
    x = x0.reshape(-1)
    for _ in range(n_newton):
        fx = F(x.reshape(shape)).reshape(-1)
        scale = torch.linalg.vector_norm(x) + 1.0

        def jv(v, x=x, fx=fx, scale=scale):
            eps = fd_eps * scale / torch.clamp(torch.linalg.vector_norm(v),
                                               min=1e-30)
            return (F((x + eps * v).reshape(shape)).reshape(-1) - fx) / eps

        dx, lsq = _cycle(jv, -fx, torch.zeros_like(fx), n_krylov, r=-fx,
                         nonfinite_nan=True)
        if record is not None:
            record.append(lsq)
        x = x + dx
    return x.reshape(shape), torch.linalg.vector_norm(F(x.reshape(shape)))


class NoPreconditioner:
    """The identity."""

    def __call__(self, v):
        return v


class ColumnwiseLUPreconditioner:
    """(I − α·dt·L)⁻¹ of the vertical operator held by a dense column
    solver (``solvers.columnwise.ManyColumnSolver``), factored once here
    and applied to a flat var-major vector of the grid's state."""

    def __init__(self, col_solver, alpha_dt: float):
        self.col = col_solver
        self.alpha_dt = float(alpha_dt)
        col_solver.prefactorize(self.alpha_dt)

    def __call__(self, v):
        lay = self.col.layout
        shaped = v.reshape(lay.n_horz * lay.n_vert, lay.nvars, lay.Np)
        return self.col.solve(shaped, self.alpha_dt).reshape(v.shape)


def generalized_conjugate_residual(op: Callable, b, x0=None,
                                   n_krylov: int = 20, restarts: int = 1):
    """Restarted GCR(k) for op(x) = b, op general: each cycle takes
    ``n_krylov`` search directions, A-orthogonalised against the cycle's
    earlier ones, minimising ‖b − op(x)‖₂ over them.  Returns (x flat,
    the recurrence's ‖r‖ as a 0-d tensor)."""
    b = b.reshape(-1)

    def A(v):
        return op(v).reshape(-1)

    def cycle(x):
        r = b - A(x)
        ps, Aps = [], []
        for _ in range(n_krylov):
            p, Ap = r, A(r)
            for pj, Apj in zip(ps, Aps):
                beta = torch.dot(Apj, Ap) / torch.dot(Apj, Apj)
                p = p - beta * pj
                Ap = Ap - beta * Apj
            denom = torch.dot(Ap, Ap)
            alpha = torch.where(denom.abs() > 1e-300, torch.dot(Ap, r) / denom,
                                torch.zeros_like(denom))
            x = x + alpha * p
            r = r - alpha * Ap
            ps.append(p)
            Aps.append(Ap)
        return x, r

    x = torch.zeros_like(b) if x0 is None else x0.reshape(-1)
    r = None
    for _ in range(restarts):
        x, r = cycle(x)
    return x, torch.linalg.vector_norm(r)
