"""Column operations of a stacked grid: cumulative (stack) integrals
and column broadcasts (port of ``climatemachine_tpu/dg/columns.py``
:39-108: ``lagrange_antiderivative_matrix``, ``ColumnOps`` with
``indefinite_integral``, ``reverse_indefinite_integral``,
``column_total``, ``broadcast_top``, ``broadcast_bottom``), with the
2-D layouts of the split-explicit coupling
(``climatemachine_tpu/ocean/split_explicit.py`` ``_col_total_2d``,
``_to_3d`` :223-234).

Fields are var-major ``[E, n, Np]`` on a stacked grid, whose element
``e = eh · n_vert + ev`` puts each column's elements next to each other
and whose node ``i + Nq₁(j + Nq₂ k)`` puts k slowest, so a field is the
stack view ``[Eh, n_vert, n, Nq₃, Nq₂·Nq₁]`` without a copy.  A stack
integral is the antiderivative matrix over an element's vertical nodes
(one contraction) plus an exclusive cumulative sum of the element totals
over the column's layers.

The 2-D layout ``[Eh, n, Nq₂·Nq₁]`` of a column field is that of the
2-D brick on the same horizontal ranges: its element ``eh = ix + nx·iy``
and node ``i + Nq₁ j`` are the stacked brick's horizontal ones.
"""

from __future__ import annotations

import numpy as np
import torch

from climatemachine_tpu_torch.mesh import elements


def lagrange_antiderivative_matrix(xi: np.ndarray) -> np.ndarray:
    """I[i, j] = ∫_{−1}^{ξᵢ} l_j(x) dx for the Lagrange basis at nodes
    ``xi`` (numpy float64, exact through polynomial antiderivatives)."""
    N = len(xi)
    I = np.zeros((N, N))
    for j in range(N):
        y = np.zeros(N)
        y[j] = 1.0
        coef = np.polynomial.polynomial.polyfit(xi, y, N - 1)
        anti = np.polynomial.polynomial.polyint(coef)
        vals = np.polynomial.polynomial.polyval(xi, anti)
        v0 = np.polynomial.polynomial.polyval(-1.0, anti)
        I[:, j] = vals - v0
    return I


class ColumnOps:
    """The static operators of a stacked grid's stack integrals."""

    def __init__(self, grid):
        if grid.n_vert is None:
            raise ValueError("stack integrals need a stacked grid")
        self.grid = grid
        self.n_vert, self.n_horz = grid.n_vert, grid.n_horz
        self.Nq = grid.Nq
        xi_v = grid.xi[grid.dim - 1]
        dev = lambda a: torch.as_tensor(a, dtype=grid.dtype,
                                        device=grid.device)
        self.Iop = dev(lagrange_antiderivative_matrix(xi_v))
        self.wv = dev(elements.lgl_points(len(xi_v) - 1)[1])
        self.JcV = grid.JcV[:, None, :]                       # [E, 1, Np]

    def to_stack(self, x):
        """``[E, n, Np]`` → ``[Eh, n_vert, n, Nq₃, Nq₂·Nq₁]`` (a view)."""
        Nq1, Nq2, Nq3 = self.Nq
        return x.reshape(self.n_horz, self.n_vert, x.shape[1], Nq3,
                         Nq2 * Nq1)

    def from_stack(self, xs):
        return xs.reshape(self.n_horz * self.n_vert, xs.shape[2],
                          self.grid.Np)

    def _layer_totals(self, fs):
        """∫ over each element's vertical extent ``[Eh, nv, n, H]`` of a
        stacked integrand (already times JcV)."""
        return torch.einsum("j,evnjh->evnh", self.wv, fs)

    def indefinite_integral(self, f):
        """I(z) = ∫_bottom^z f dz′ at every node of f ``[E, n, Np]``."""
        fs = self.to_stack(f * self.JcV)
        cum = torch.einsum("ij,evnjh->evnih", self.Iop, fs)
        tot = self._layer_totals(fs)
        offset = torch.cumsum(tot, dim=1) - tot
        return self.from_stack(cum + offset[:, :, :, None])

    def reverse_indefinite_integral(self, f):
        """I(z) = ∫_z^top f dz′: the column total less the forward
        integral."""
        return self.column_total(f) - self.indefinite_integral(f)

    def column_total_2d(self, f):
        """∫_bottom^top f dz of each column, in the 2-D layout ``[Eh, n,
        Nq₂·Nq₁]``."""
        return self._layer_totals(self.to_stack(f * self.JcV)).sum(dim=1)

    def column_total(self, f):
        """∫_bottom^top f dz at every node of the column."""
        return self.broadcast_2d(self.column_total_2d(f))

    def broadcast_2d(self, f2):
        """A 2-D field ``[Eh, n, Nq₂·Nq₁]`` at every node of its column,
        ``[E, n, Np]``."""
        Nq3 = self.Nq[-1]
        return self.from_stack(f2[:, None, :, None, :].expand(
            self.n_horz, self.n_vert, f2.shape[1], Nq3, f2.shape[-1]))

    def broadcast_top(self, x):
        """The value at the column's top node at every node of it."""
        xs = self.to_stack(x)
        return self.from_stack(xs[:, -1:, :, -1:].expand(xs.shape))

    def broadcast_bottom(self, x):
        """The value at the column's bottom node at every node of it."""
        xs = self.to_stack(x)
        return self.from_stack(xs[:, :1, :, :1].expand(xs.shape))


class ColumnOpsCache:
    """The :class:`ColumnOps` of each grid a model is given, built at its
    first call for that grid (a grid freed and another built at its
    address gets its own)."""

    def __init__(self):
        self._ops = {}

    def __call__(self, grid) -> ColumnOps:
        ent = self._ops.get(id(grid))
        if ent is None or ent[0] is not grid:
            ent = self._ops[id(grid)] = (grid, ColumnOps(grid))
        return ent[1]
