"""Columnwise implicit solvers for HEVI vertical operators (port of
``climatemachine_tpu/solvers/columnwise.py``: ColumnLayout :42-90 with
VMColumnLayout :93-139, BlockTridiagColumnSolver :142-431 and
ManyColumnSolver :434-514).

The vertical implicit operator couples only the nodes of one vertical
column of a stacked grid, so the backward-Euler system is many small
independent solves.

- ``BlockTridiagColumnSolver``: the first-order vertical DG operator
  couples an element only to its two vertical neighbours, so in
  (element, node, var) column order the matrix is block-tridiagonal with
  block size nb = Nq3·nvars.  Assembly probes the operator with a
  period-3 element comb (3·nb applications); factor and solve are a
  block-Thomas sweep, a Python loop over the nv vertical elements.
- ``ManyColumnSolver``: assembles the dense per-column matrix by Nv
  basis probes; the small-grid oracle.

Operator and factor blocks are stored ``[nv, ncol, i, j]`` (row i,
contraction axis j last), so each block product is one batched
``torch.matmul`` over the ncol columns; the JAX package stores
``[nv, j, i, ncol]``, the column axis on the TPU's lanes, and multiplies
and sums over j, which on the H100 is the slower form of the two
(``chip_smoke.py`` imex_path times both; PERF.md).  Vectors stay in the
block layout ``[nv, nb, ncol]`` of the layout kernels.  Every contraction runs in full float32: the JAX
package's IMEX step blew up at step ~45 when the solver's dots ran in
bf16 on the TPU; on the card the same trap is TF32, which the solver
refuses.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from climatemachine_tpu_torch.device import require_full_fp32
from climatemachine_tpu_torch.solvers import layout_kernel


class ColumnLayout:
    """Var-major grid state ``[E, nvars, Np]`` ↔ column batch
    ``[ncol, Nv]`` and column blocks ``[nv, Nq3·nvars, ncol]``.

    Stacked grids order elements e = eh·n_vert + ev and nodes
    n = i + Nq1·(j + Nq2·k); a column is (eh, j, i) with Nv =
    n_vert·Nq3·nvars unknowns ordered (ev, k, var), bottom to top.  The
    block conversions are ``to_blocks``/``from_blocks(tensor,
    layout_dims)``: the layout kernels' wrappers
    (solvers/layout_kernel.py) unless the caller passes others, as
    chip_smoke.py passes their plain versions to hold a step against
    the kernels'."""

    def __init__(self, grid, nvars: int,
                 to_blocks: Callable = layout_kernel.to_blocks_vm,
                 from_blocks: Callable = layout_kernel.from_blocks_vm):
        self._to_blocks, self._from_blocks = to_blocks, from_blocks
        if grid.n_vert is None:
            raise ValueError("the columnwise solve needs a stacked grid")
        self.nvars = nvars
        self.n_vert, self.n_horz = grid.n_vert, grid.n_horz
        self.Nq, self.Np = grid.Nq, grid.Np
        Nq1, Nq2, Nq3 = grid.Nq
        self.ncol = self.n_horz * Nq2 * Nq1
        self.Nv = self.n_vert * Nq3 * nvars
        self.layout_dims = (self.n_horz, self.n_vert, nvars, Nq3, Nq2 * Nq1)

    def to_columns(self, x):
        Nq1, Nq2, Nq3 = self.Nq
        xb = x.reshape(self.n_horz, self.n_vert, self.nvars, Nq3, Nq2, Nq1)
        xb = xb.permute(0, 4, 5, 1, 3, 2)            # [Eh, j, i, ev, k, v]
        return xb.reshape(self.ncol, self.Nv)

    def from_columns(self, xc):
        Nq1, Nq2, Nq3 = self.Nq
        xb = xc.reshape(self.n_horz, Nq2, Nq1, self.n_vert, Nq3, self.nvars)
        xb = xb.permute(0, 3, 5, 4, 1, 2)            # [Eh, ev, v, k, j, i]
        return xb.reshape(self.n_horz * self.n_vert, self.nvars, self.Np)

    def to_blocks(self, x):
        """``[E, nvars, Np]`` → ``[nv, (k, var), (Eh, j, i)]``."""
        return self._to_blocks(x, self.layout_dims)

    def from_blocks(self, yb):
        return self._from_blocks(yb, self.layout_dims)


class BlockTridiagColumnSolver:
    """Columnwise solve of (I − α·dt·L) by block-Thomas.

    ``op(q) -> Lq`` must be linear (affine), column-local, and couple at
    most adjacent vertical elements (any first-order vertical DG
    operator, such as the AtmosLinearModel family).  A wider stencil is
    caught at setup by a random matvec check (``seed`` seeds its
    generator) and raises.  The solve is a direct factorization of the
    assembled operator, so the ARK step takes its implicit tendency from
    :meth:`apply_op_blocks`, the same operator."""

    exact_linear_solve = True

    def __init__(self, op: Callable, layout: ColumnLayout, example_q,
                 check: bool = True, seed: int = 0):
        require_full_fp32("the column solver")
        self.layout, self.op = layout, op
        lay = layout
        nv, ncol = lay.n_vert, lay.ncol
        nb = lay.Nq[2] * lay.nvars          # block = one element's column slab
        self.nb = nb
        dtype, dev = example_q.dtype, example_q.device

        self.b_cols = lay.to_blocks(op(torch.zeros_like(example_q)))

        # Period-3 comb probing: a unit vector at within-block index m of
        # every 3rd element; the response at element ev comes from the one
        # probed element in {ev−1, ev, ev+1}.  Each response is routed into
        # the lower/diagonal/upper blocks as it comes.
        self.L, self.D, self.U = (
            torch.zeros((nv, nb, nb, ncol), dtype=dtype, device=dev)
            for _ in range(3))
        ev = torch.arange(nv, device=dev)
        for p in range(3 * nb):
            r, m = divmod(p, nb)
            col = torch.zeros((nv, nb), dtype=dtype, device=dev)
            col[ev % 3 == r, m] = 1.0
            qc = col.reshape(1, lay.Nv).expand(ncol, lay.Nv)
            resp = lay.to_blocks(op(lay.from_columns(qc))) - self.b_cols
            for d, blk in ((-1, self.L), (0, self.D), (1, self.U)):
                src = ev + d
                rows = ev[(src >= 0) & (src < nv) & (src % 3 == r)]
                blk[rows, m] = resp[rows]
        # [nv, j, i, ncol] → [nv, ncol, i, j]
        self.L, self.D, self.U = (B.permute(0, 3, 2, 1).contiguous()
                                  for B in (self.L, self.D, self.U))
        self._cached = {}

        # Inactive-unknown compression: block indices whose row and column
        # vanish in every block are solved trivially (q_m = rhs_m + αdt·b_m)
        # and sliced out of the blocks.
        pat = (self.L.abs() + self.D.abs() + self.U.abs()).amax(dim=(0, 1))
        pat = pat.cpu().numpy()                          # [nb(i), nb(j)]
        active = (pat.max(axis=1) > 0) | (pat.max(axis=0) > 0)
        sel = np.flatnonzero(active)
        if not 0 < len(sel) < nb:
            sel = np.arange(nb)
        self._sel = torch.as_tensor(sel, device=dev)
        self.full = len(sel) == nb
        if self.full:
            self.Lc, self.Dc, self.Uc = self.L, self.D, self.U
        else:
            s = self._sel
            self.Lc, self.Dc, self.Uc = (B[:, :, s][:, :, :, s]
                                         for B in (self.L, self.D, self.U))

        if check:
            # a wider-than-tridiagonal stencil would alias under the
            # period-3 comb: verify with a random matvec
            gen = torch.Generator(device=dev).manual_seed(seed)
            x = torch.randn(example_q.shape, generator=gen, dtype=dtype,
                            device=dev)
            got = self._matvec(lay.to_columns(x))
            want = lay.to_columns(op(x)) - self._unblk(self.b_cols)
            scale = want.abs().max().item() + 1e-300
            tol = 1e-4 if dtype == torch.float32 else 1e-10
            err = (got - want).abs().max().item()
            if err > tol * scale:
                raise ValueError(
                    "operator couples beyond adjacent vertical elements "
                    f"(matvec residual {err:.3e} vs scale {scale:.3e}); "
                    "use the dense ManyColumnSolver")

    @property
    def active_count(self) -> int:
        """s, the unknowns per block left after compression."""
        return len(self._sel)

    def _blk(self, xc):
        """``[ncol, Nv]`` → ``[nv, nb, ncol]``."""
        lay = self.layout
        return xc.reshape(lay.ncol, lay.n_vert, self.nb).permute(1, 2, 0)

    def _unblk(self, yb):
        """``[nv, nb, ncol]`` → ``[ncol, Nv]``."""
        return yb.permute(2, 0, 1).reshape(self.layout.ncol, self.layout.Nv)

    @staticmethod
    def _bmv(M, v):
        """Block matvec: M ``[.., ncol, i, j]`` · v ``[.., j, ncol]`` →
        ``[.., i, ncol]``, one batched matmul over the columns."""
        return torch.matmul(M, v.transpose(-1, -2).unsqueeze(-1)) \
            .squeeze(-1).transpose(-1, -2)

    def _matvec(self, xc):
        xb = self._blk(xc)
        y = self._bmv(self.D, xb)
        y[1:] += self._bmv(self.L[1:], xb[:-1])
        y[:-1] += self._bmv(self.U[:-1], xb[1:])
        return self._unblk(y)

    def op_args(self, dtype=None):
        """The operator arrays for :meth:`apply_op_blocks`: (L, D, U, b),
        compressed.  A reduced-precision copy (the JAX package's opt-in
        bf16 operator) is not ported."""
        if dtype is not None:
            raise NotImplementedError("next slice: reduced-precision "
                                      "operator blocks")
        return (self.Lc, self.Dc, self.Uc, self.b_cols)

    def apply_op_blocks(self, xb, args=None):
        """L·x + b in block layout ``[nv, nb, ncol]``."""
        L, D, U, b = args if args is not None else self.op_args()
        xs = xb if self.full else xb[:, self._sel]
        y = self._bmv(D, xs)
        y[1:] += self._bmv(L[1:], xs[:-1])
        y[:-1] += self._bmv(U[:-1], xs[1:])
        if not self.full:
            out = torch.zeros_like(xb)
            out[:, self._sel] = y
            y = out
        return y + b

    def apply_op(self, q, args=None):
        """L·q + b through the assembled operator, grid layout."""
        lay = self.layout
        return lay.from_blocks(self.apply_op_blocks(lay.to_blocks(q), args))

    def _factor(self, alpha_dt: float):
        """Block-Thomas factorization of I − α·dt·A: the pivot-block
        inverses S⁻¹ and C = S⁻¹·U', with the scaled lower blocks, each
        ``[nv, ncol, i, j]``."""
        eye = torch.eye(self.active_count, dtype=self.D.dtype,
                        device=self.D.device)
        Dm = eye - alpha_dt * self.Dc
        Lm = -alpha_dt * self.Lc
        Um = -alpha_dt * self.Uc
        Sinv, C = [], []
        C_prev = torch.zeros_like(Dm[0])
        for k in range(self.layout.n_vert):
            S = Dm[k] - torch.bmm(Lm[k], C_prev)
            Sinv.append(torch.linalg.inv(S))
            C_prev = torch.bmm(Sinv[-1], Um[k])
            C.append(C_prev)
        return torch.stack(Sinv), torch.stack(C), Lm

    def prefactorize(self, alpha_dt: float):
        """Factor for ``alpha_dt`` once and keep it (the ESDIRK tableaus
        use one γ·dt for every implicit stage)."""
        key = float(alpha_dt)
        if key not in self._cached:
            self._cached[key] = self._factor(alpha_dt)
        return self._cached[key]

    def drop_factors(self, keep):
        """Drop the kept factorizations of every α·dt not in ``keep``."""
        for key in [k for k in self._cached if k not in keep]:
            del self._cached[key]

    def solve_blocks(self, rhs_b, alpha_dt, factors=None):
        """x with (I − α·dt·L) x = rhs, all ``[nv, nb, ncol]``: block
        forward and back substitution."""
        fac = factors
        if fac is None:
            fac = self._cached.get(float(alpha_dt))
        if fac is None:
            fac = self._factor(alpha_dt)
        Sinv, C, Lm = fac
        rv = rhs_b + alpha_dt * self.b_cols
        rs = rv if self.full else rv[:, self._sel]
        bmv, nv = self._bmv, self.layout.n_vert
        ys = []
        y = torch.zeros_like(rs[0])
        for k in range(nv):
            y = bmv(Sinv[k], rs[k] - bmv(Lm[k], y))
            ys.append(y)
        xs = [None] * nv
        x = torch.zeros_like(ys[-1])
        for k in reversed(range(nv)):
            x = ys[k] - bmv(C[k], x)
            xs[k] = x
        xs = torch.stack(xs)
        if self.full:
            return xs
        # inactive rows have zero operator rows: q = rhs + αdt·b
        rv = rv.clone()
        rv[:, self._sel] = xs
        return rv

    def solve(self, rhs, alpha_dt, factors=None):
        """q with (I − α·dt·L) q = rhs, grid layout."""
        lay = self.layout
        return lay.from_blocks(self.solve_blocks(lay.to_blocks(rhs),
                                                 alpha_dt, factors))


#: the bytes of the column matrices one batched inverse takes at a time
#: (ManyColumnSolver._factor)
INV_CHUNK_BYTES = 1 << 30


class ManyColumnSolver:
    """Dense per-column factor and apply of (I − α·dt·L): Nv basis probes
    assemble A ``[ncol, Nv, Nv]``, inverted once per α·dt; each solve and
    each application is one batched matrix-vector product.  O(ncol·Nv²)
    memory (in float32 at n_horz=16, n_vert=8, p4: 6.1 GB per matrix
    with 5 variables, 19.9 GB with 9): the small-grid oracle of the
    block-tridiagonal solver, and the dense ``columnwise_solver`` of the
    IMEX step, whose ARK step has no block layout (``ode/ark.py``
    ``_step_impl``).  The probes are written into A in place, one column
    at a time; the batched products and the inverse are library calls,
    as the JAX package leaves them to XLA."""

    exact_linear_solve = True

    def __init__(self, op: Callable, layout: ColumnLayout, example_q):
        require_full_fp32("the column solver")
        self.layout, self.op = layout, op
        lay = layout
        self.b_cols = lay.to_columns(op(torch.zeros_like(example_q)))
        self.A = torch.empty((lay.ncol, lay.Nv, lay.Nv),
                             dtype=example_q.dtype, device=example_q.device)
        e = torch.zeros(lay.Nv, dtype=example_q.dtype,
                        device=example_q.device)
        for k in range(lay.Nv):
            e.zero_()
            e[k] = 1.0
            qk = lay.from_columns(e.expand(lay.ncol, lay.Nv))
            self.A[:, :, k] = lay.to_columns(op(qk)) - self.b_cols
        self._cached = {}

    def op_args(self, dtype=None):
        """The operator for :meth:`apply_op`: (A, b).  A reduced-precision
        copy (the JAX package's opt-in bf16 operator) is not ported."""
        if dtype is not None:
            raise NotImplementedError("next slice: a reduced-precision "
                                      "operator")
        return (self.A, self.b_cols)

    def apply_op(self, q, args=None):
        """L·q + b through the assembled operator."""
        lay = self.layout
        A, b = args if args is not None else self.op_args()
        yc = torch.matmul(A, lay.to_columns(q).unsqueeze(-1)).squeeze(-1)
        return lay.from_columns(yc + b)

    def _factor(self, alpha_dt: float):
        """(I − α·dt·A)⁻¹, inverted in batches of INV_CHUNK_BYTES of
        columns: beside A and the result, the inverse's temporaries (the
        shifted matrix, its LU factors, the identity it solves against)
        take a few such batches, not a few copies of A."""
        A = self.A
        out = torch.empty_like(A)
        step = max(1, INV_CHUNK_BYTES // (A[0].numel() * A.element_size()))
        for c0 in range(0, A.shape[0], step):
            m = A[c0:c0 + step] * -alpha_dt
            m.diagonal(dim1=-2, dim2=-1).add_(1.0)
            out[c0:c0 + step] = torch.linalg.inv(m)
        return out

    def prefactorize(self, alpha_dt: float):
        """Invert (I − α·dt·A) per column once per α·dt and keep it."""
        key = float(alpha_dt)
        if key not in self._cached:
            self._cached[key] = self._factor(alpha_dt)
        return self._cached[key]

    def drop_factors(self, keep):
        """Drop the kept inverses of every α·dt not in ``keep``."""
        for key in [k for k in self._cached if k not in keep]:
            del self._cached[key]

    def solve(self, rhs, alpha_dt, factors=None):
        """q with (I − α·dt·L) q = rhs: ``factors`` if given, else the
        factorization kept for α·dt, else a new one (not kept)."""
        lay = self.layout
        Minv = factors
        if Minv is None:
            Minv = self._cached.get(float(alpha_dt))
        if Minv is None:
            Minv = self._factor(alpha_dt)
        r = lay.to_columns(rhs) + alpha_dt * self.b_cols
        return lay.from_columns(
            torch.matmul(Minv, r.unsqueeze(-1)).squeeze(-1))
