"""Modal filters (port of ``climatemachine_tpu/mesh/filters.py``:
spectral_filter_matrix, ``SpectralFilter`` :88-134 with its
``direction`` argument, ``nodal_matrix`` :108 and ``apply_vm`` :128,
``ExponentialFilter`` :137, ``CutoffFilter`` :169), and the TMAR
positivity filter ``tmar`` :195-211.

The per-dimension filter matrices V diag(σ) V⁻¹ are built in numpy
float64 and rounded to the grid dtype, as the JAX package stores them.
Calling a filter contracts the var-major state ``[E, n, Np]`` with the
matrices of the direction's reference dims, one dim at a time (the
ocean's vertical filters: Nq₃ × Nq₃ over k); ``apply_vm`` (every
direction, the Held-Suarez step filter) is one ``torch.matmul`` with
the composed ``[Np, Np]`` nodal operator.  ``tmar`` sums over each
element's nodes, the last axis of the var-major state.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from climatemachine_tpu_torch.dg.directions import direction_dims


def _legendre_vandermonde(r: np.ndarray) -> np.ndarray:
    """Orthonormal Legendre Vandermonde at points ``r``."""
    N = len(r) - 1
    V = np.zeros((N + 1, N + 1))
    V[:, 0] = np.ones_like(r) / math.sqrt(2.0)
    if N >= 1:
        V[:, 1] = r * math.sqrt(3.0 / 2.0)
        for n in range(1, N):
            a = math.sqrt((2 * n + 1) * (2 * n + 3)) / (n + 1)
            b = n / (n + 1) * math.sqrt((2 * n + 3) / (2 * n - 1))
            V[:, n + 1] = a * r * V[:, n] - b * V[:, n - 1]
    return V


def spectral_filter_matrix(r: np.ndarray, Nc: int,
                           sigma: Callable[[float], float]) -> np.ndarray:
    """V diag(Σ) V⁻¹ with Σ[i] = σ((i − Nc)/(N − Nc)) for i ≥ Nc."""
    N = len(r) - 1
    if Nc > N:
        return np.eye(N + 1)
    V = _legendre_vandermonde(np.asarray(r, dtype=np.float64))
    S = np.ones(N + 1)
    denom = max(N - Nc, 1)
    for i in range(Nc, N + 1):
        S[i] = sigma((i - Nc) / denom)
    return V @ np.diag(S) @ np.linalg.inv(V)


def _normalize_Nc(Nc, dim: int = 3):
    """A cut-off per dim from an int, (horizontal, vertical) or one per
    dim."""
    if isinstance(Nc, int):
        return (Nc,) * dim
    Nc = tuple(Nc)
    if len(Nc) == 2 and dim == 3:
        return (Nc[0], Nc[0], Nc[1])
    return Nc


class SpectralFilter:
    """A filter from one matrix per reference dim (``matrices``, numpy,
    already rounded to the grid dtype)."""

    def __init__(self, grid, matrices):
        self.Nq = grid.Nq
        self.matrices = tuple(np.asarray(m, dtype=np.float64)
                              for m in matrices)
        self.mats = tuple(torch.as_tensor(m, dtype=grid.dtype,
                                          device=grid.device)
                          for m in self.matrices)
        self.nodal = torch.as_tensor(self.nodal_matrix(), dtype=grid.dtype,
                                     device=grid.device)

    def nodal_matrix(self, direction: str = "every") -> np.ndarray:
        """The composed ``[Np, Np]`` operator F (out = F q per element and
        variable) over the direction's dims, in float64."""
        Np = int(np.prod(self.Nq))
        xb = np.eye(Np).reshape(tuple(self.Nq[::-1]) + (Np,))
        for d in direction_dims(direction, 3):
            out = np.tensordot(xb, self.matrices[d], axes=((2 - d,), (1,)))
            xb = np.moveaxis(out, -1, 2 - d)
        return xb.reshape(Np, Np)

    def __call__(self, qv, direction: str = "every"):
        """Filter var-major ``qv [E, n, Np]`` along the direction's
        reference dims (an axis-wise contraction a dim)."""
        E, n, Np = qv.shape
        Nq1, Nq2, Nq3 = self.Nq
        xb = qv.reshape(E * n, Nq3, Nq2, Nq1)
        for d in direction_dims(direction, 3):
            F = self.mats[d]
            if d == 0:
                xb = torch.matmul(xb, F.T)
            elif d == 1:
                xb = torch.matmul(F, xb)
            else:
                xb = torch.matmul(F, xb.reshape(E * n, Nq3, Nq2 * Nq1))
                xb = xb.reshape(E * n, Nq3, Nq2, Nq1)
        return xb.reshape(E, n, Np)

    def apply_vm(self, qv):
        """Filter var-major ``qv [E, n, Np]`` in every direction with one
        matmul."""
        E, n, Np = qv.shape
        return torch.matmul(qv.reshape(E * n, Np),
                            self.nodal.T).reshape(E, n, Np)


def _matrices(grid, Nc, sigma):
    """One filter matrix per dim, rounded to the grid dtype."""
    np_dtype = torch.empty((), dtype=grid.dtype).numpy().dtype
    return [spectral_filter_matrix(grid.xi[d], c, sigma)
            .astype(np_dtype).astype(np.float64)
            for d, c in enumerate(_normalize_Nc(Nc))]


class ExponentialFilter(SpectralFilter):
    """σ(η) = exp(−α η^s) above mode ``Nc``."""

    def __init__(self, grid, Nc=0, s: int = 32):
        alpha = -math.log(np.finfo(np.float64).eps)
        if s % 2:
            raise ValueError("filter order s must be even")
        super().__init__(grid, _matrices(
            grid, Nc, lambda eta: math.exp(-alpha * eta ** s)))


class CutoffFilter(SpectralFilter):
    """Zero every mode from ``Nc`` on (default: the top mode of each
    dim)."""

    def __init__(self, grid, Nc=None):
        if Nc is None:
            Nc = tuple(nq - 1 for nq in grid.Nq)
        super().__init__(grid, _matrices(grid, Nc, lambda eta: 0.0))


def tmar(grid, q, fields: Optional[Sequence[int]] = None):
    """The truncation-and-mass-aware rescaling positivity filter (Light &
    Durran 2016) of var-major q ``[E, n, Np]``: in each element, the
    negative values clipped to 0 and the rest scaled so that the
    element's M-weighted integral is max(its integral, 0) (0 where
    nothing positive is left); ``fields`` the lanes filtered (default:
    all), the others kept."""
    M = grid.M[:, None]                                   # [E, 1, Np]
    qc = torch.clamp_min(q, 0.0)
    num = torch.sum(M * q, dim=2, keepdim=True)
    den = torch.sum(M * qc, dim=2, keepdim=True)
    pos = den > 0
    scale = torch.where(pos, torch.clamp_min(num, 0.0)
                        / torch.where(pos, den, 1.0), 0.0)
    out = qc * scale
    if fields is None:
        return out
    res = q.clone()
    res[:, list(fields)] = out[:, list(fields)]
    return res
