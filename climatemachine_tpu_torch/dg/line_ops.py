"""Line tables of the Kronecker derivative operators, for the CUDA kernels.

Each direction block of the DG operators is a Kronecker product: the 1-D
derivative matrix D_a (or its transpose) on axis a of the Nq × Nq × Nq
node lattice and the identity on the other two axes
(``mesh/grid.py``: ``Wdiv = [D_0ᵀ ⊗ I ⊗ I | …]``, ``Wgrad`` the same way,
node n = (n_2·Nq + n_1)·Nq + n_0).  So the row of output node m has Nq
nonzeros, all on m's line along axis a: the nodes ``base + j·s`` for
j < Nq, with s = Nq^a the axis's node stride and ``base = m − i·s``,
i = (m / s) mod Nq the position of m on its line.  The sum-factorised
kernels (csrc/ldg_chain.cu, csrc/volume_vm.cu) read those entries from a
:class:`LineOps` table in ascending j, which is ascending k, so that
their FMA chains equal the dense loops over all k of the kernels they
replace: an FMA with an exact zero weight leaves its sum as it was.

The tables are exact copies of the operator tensor's entries.  Building
one checks the structure: a matrix that the table does not rebuild
element for element (a nonzero off its line, or line weights that vary
across the lattice) raises.  There is no dense fallback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary


@dataclass(frozen=True)
class LineOps:
    """Per direction a: the node stride ``strides[a]`` of its lines and
    ``values [nd, Nq, Nq]``, ``values[a, i, j]`` the weight of a line's
    node j in the output at its node i, in the operator's dtype and on
    its device."""
    strides: Tuple[int, ...]
    values: torch.Tensor

    @property
    def nq(self) -> int:
        return self.values.shape[1]

    def dense(self) -> torch.Tensor:
        """The operator ``[nd, Np, Np]`` (output node, input node) that
        the table describes."""
        vals = self.values.detach().cpu().numpy()
        blocks = [_rebuild(vals[a], s, self.nq)
                  for a, s in enumerate(self.strides)]
        return torch.as_tensor(np.stack(blocks), device=self.values.device)


def _rebuild(values, stride: int, nq: int):
    """The [Np, Np] block with line weights ``values [Nq, Nq]`` along the
    lattice axis of node stride ``stride``."""
    Np = nq ** 3
    m = np.arange(Np)
    i = (m // stride) % nq
    cols = (m - i * stride)[:, None] + stride * np.arange(nq)[None, :]
    out = np.zeros((Np, Np), dtype=values.dtype)
    out[m[:, None], cols] = values[i]
    return out


def line_ops(blocks: torch.Tensor) -> LineOps:
    """The line table of ``blocks [nd, Np, Np]`` (output node, input
    node), Np = Nq³; raises ValueError unless every block is a 1-D
    operator along one lattice axis, rebuilt exactly by its table."""
    nd, Np, Np2 = blocks.shape
    nq = round(Np ** (1.0 / 3.0))
    if Np != Np2 or nq ** 3 != Np:
        raise ValueError(f"line_ops: need [nd, Nq³, Nq³] blocks, got "
                         f"{tuple(blocks.shape)}")
    host = blocks.detach().cpu().numpy()
    strides, values = [], []
    line = np.arange(nq)
    for a in range(nd):
        for s in (nq ** d for d in range(3)):
            vals = host[a][np.ix_(s * line, s * line)]
            if np.array_equal(_rebuild(vals, s, nq), host[a]):
                strides.append(s)
                values.append(vals)
                break
        else:
            raise ValueError(
                f"line_ops: direction block {a} is not a Kronecker line "
                "operator (a nonzero off its line, or line weights that "
                "vary across the lattice)")
    return LineOps(strides=tuple(strides),
                   values=torch.as_tensor(np.stack(values),
                                          device=blocks.device))


#: the line orders the sum-factorised kernels are built for
#: (csrc/tile_pipeline.cuh:by_order): p1-p5, every Np <= 256 that the
#: one-thread-per-node kernels before them covered
KERNEL_NQ = (2, 3, 4, 5, 6)


def check_kernel_order(name: str, Np: int):
    """Raise ValueError unless a sum-factorised kernel is built for
    elements of ``Np`` nodes (Np = Nq³, Nq in KERNEL_NQ)."""
    if Np not in {nq ** 3 for nq in KERNEL_NQ}:
        raise ValueError(
            f"the CUDA {name} kernel is built for Np = Nq³ with Nq in "
            f"{KERNEL_NQ} (p1-p5), got Np={Np}")


_CACHE = WeakIdKeyDictionary()


def _cached(op: torch.Tensor, blocks) -> LineOps:
    """``line_ops(blocks(op))``, built once per tensor ``op``, kept while
    it lives and rebuilt if it is written in place."""
    hit = _CACHE.get(op)
    if hit is None or hit[0] != op._version:
        hit = _CACHE[op] = (op._version, line_ops(blocks(op)))
    return hit[1]


def wd_lines(Wd: torch.Tensor) -> LineOps:
    """The table of the chain's ``Wd [nd, Np, Np]`` (d_a[m] = Σ_k x[k] ·
    Wd[a, k, m])."""
    return _cached(Wd, lambda w: w.transpose(1, 2))


def wdiv_lines(Wdiv: torch.Tensor) -> LineOps:
    """The table of the weak divergence ``Wdiv [Np, 3Np]`` (out[n] =
    Σ_a Σ_k Wdiv[n, a·Np + k] · mf[a, k])."""
    Np = Wdiv.shape[0]
    return _cached(Wdiv, lambda w: w.reshape(Np, -1, Np).transpose(0, 1))
