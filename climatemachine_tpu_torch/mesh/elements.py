"""1-D spectral-element operators on Legendre-Gauss-Lobatto nodes (port of
``climatemachine_tpu/mesh/elements.py``: lgl_points, derivative_matrix).

Host-side numpy float64; the grid uploads the results to the device.
"""

from __future__ import annotations

import numpy as np


def lgl_points(n_poly: int) -> tuple[np.ndarray, np.ndarray]:
    """(N+1) LGL nodes and quadrature weights on [-1, 1]: roots of
    (1-x^2) P'_N(x) by Newton from the Chebyshev-Gauss-Lobatto guess,
    weights w_j = 2/(N(N+1) P_N(x_j)^2)."""
    n = n_poly
    if n < 1:
        raise ValueError("lgl_points needs polynomial order >= 1")
    if n == 1:
        return np.array([-1.0, 1.0]), np.array([1.0, 1.0])
    x = -np.cos(np.pi * np.arange(n + 1) / n)
    x_old = np.full_like(x, 2.0)
    P = np.zeros((n + 1, n + 1))
    for _ in range(200):
        if np.max(np.abs(x - x_old)) < 1e-15:
            break
        x_old = x.copy()
        P[:, 0] = 1.0
        P[:, 1] = x
        for k in range(2, n + 1):
            P[:, k] = ((2 * k - 1) * x * P[:, k - 1]
                       - (k - 1) * P[:, k - 2]) / k
        x = x_old - (x * P[:, n] - P[:, n - 1]) / ((n + 1) * P[:, n])
    w = 2.0 / (n * (n + 1) * P[:, n] ** 2)
    x[0], x[-1] = -1.0, 1.0
    return x, w


def bary_weights(r: np.ndarray) -> np.ndarray:
    """Barycentric weights for nodes ``r`` (Berrut & Trefethen 2004)."""
    diff = r[:, None] - r[None, :]
    np.fill_diagonal(diff, 1.0)
    return 1.0 / np.prod(diff, axis=1)


def derivative_matrix(r: np.ndarray) -> np.ndarray:
    """Spectral differentiation matrix D with D[j,k] = l'_k(r_j)."""
    wb = bary_weights(r)
    n = len(r)
    D = np.zeros((n, n))
    for j in range(n):
        for k in range(n):
            if j != k:
                D[j, k] = (wb[k] / wb[j]) / (r[j] - r[k])
        D[j, j] = np.sum([1.0 / (r[j] - r[l]) for l in range(n) if l != j])
    return D
