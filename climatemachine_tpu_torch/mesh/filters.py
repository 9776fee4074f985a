"""Exponential modal filter (port of ``climatemachine_tpu/mesh/filters.py``:
spectral_filter_matrix, ExponentialFilter :137, nodal_matrix :108,
apply_vm :128).

The per-dimension filter matrices V diag(σ) V⁻¹ are built in numpy
float64, rounded to the grid dtype (as the JAX package stores them),
and composed into one ``[Np, Np]`` nodal operator; ``apply_vm`` is one
``torch.matmul`` over the var-major state.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


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


class ExponentialFilter:
    """σ(η) = exp(−α η^s) above mode ``Nc`` in every reference direction."""

    def __init__(self, grid, Nc: int = 0, s: int = 32):
        alpha = -math.log(np.finfo(np.float64).eps)
        if s % 2:
            raise ValueError("filter order s must be even")
        sigma = lambda eta: math.exp(-alpha * eta ** s)
        np_dtype = torch.empty((), dtype=grid.dtype).numpy().dtype
        self.matrices = tuple(
            spectral_filter_matrix(grid.xi[d], Nc, sigma)
            .astype(np_dtype).astype(np.float64) for d in range(3))
        self.Nq = grid.Nq
        self.nodal = torch.as_tensor(self.nodal_matrix(), dtype=grid.dtype,
                                     device=grid.device)

    def nodal_matrix(self) -> np.ndarray:
        """The composed ``[Np, Np]`` operator F (out = F q per element and
        variable), in float64."""
        Np = int(np.prod(self.Nq))
        xb = np.eye(Np).reshape(tuple(self.Nq[::-1]) + (Np,))
        for d in range(3):
            out = np.tensordot(xb, self.matrices[d], axes=((2 - d,), (1,)))
            xb = np.moveaxis(out, -1, 2 - d)
        return xb.reshape(Np, Np)

    def apply_vm(self, qv):
        """Filter var-major ``qv [E, n, Np]`` with one matmul."""
        E, n, Np = qv.shape
        return torch.matmul(qv.reshape(E * n, Np),
                            self.nodal.T).reshape(E, n, Np)
