"""The line tables of the Kronecker derivative operators
(climatemachine_tpu_torch.dg.line_ops), which the sum-factorised CUDA
kernels read in place of the dense ``Wd`` and ``Wdiv``, on the CPU:

- each table rebuilds its operator exactly, element for element, at
  every order the kernels are built for (p1-p5) in float32 and float64,
  so the kernels multiply by the very entries of the tensors the plain
  versions multiply by;
- each line's entries come out in ascending input node, the order of
  the dense loops that the kernels' FMA chains must repeat;
- a matrix with one nonzero off its lines, or with line weights that
  vary across the lattice, raises;
- a table is built once per operator tensor and rebuilt after the
  tensor is written in place;
- a gather through the tables equals the dense ``torch.matmul`` in
  float64 within 1e-13 of max|dense|;
- the wrappers' order check accepts exactly the orders that the CUDA
  sources dispatch on (csrc/tile_pipeline.cuh:by_order).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from climatemachine_tpu_torch.dg.ldg_tables import W_for
from climatemachine_tpu_torch.dg.line_ops import (KERNEL_NQ,
                                                  check_kernel_order,
                                                  line_ops, wd_lines,
                                                  wdiv_lines)
from climatemachine_tpu_torch.experiments.held_suarez import \
    held_suarez_config

HORIZONTAL = (0, 1)


def _operators(poly, dtype):
    """(Wd [2, Np, Np] of the horizontal chain, Wdiv [Np, 3Np]) as the
    port builds them (dg/ldg_kernel.py:chain_operators, mesh/grid.py)."""
    g = held_suarez_config(1, 1, poly, dtype=dtype, hyperdiffusion_tau=None,
                           device="cpu").grid
    Np = g.Np
    Wd = W_for(g, HORIZONTAL).reshape(2, Np, Np).transpose(1, 2).contiguous()
    return Wd, g.Wdiv


def _blocks(name, op):
    """The operator as [nd, out node, in node] blocks."""
    if name == "Wd":
        return op.transpose(1, 2)
    return op.reshape(op.shape[0], 3, -1).transpose(0, 1)


TABLES = {"Wd": wd_lines, "Wdiv": wdiv_lines}
CASES = [(nq - 1, dt) for nq in KERNEL_NQ
         for dt in (torch.float32, torch.float64)]


@pytest.mark.parametrize("poly,dtype", CASES,
                         ids=[f"p{p}-{str(d)[6:]}" for p, d in CASES])
def test_tables_rebuild_operators_exactly(poly, dtype):
    ops = dict(zip(("Wd", "Wdiv"), _operators(poly, dtype)))
    nq = poly + 1
    for name, op in ops.items():
        tab = TABLES[name](op)
        assert tab.values.dtype == dtype and tab.nq == nq
        assert tab.strides == ((1, nq) if name == "Wd" else (1, nq, nq * nq))
        torch.testing.assert_close(tab.dense(), _blocks(name, op), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("poly", (3, 4))
def test_line_entries_in_ascending_input_node(poly):
    """Row m of each block: its nonzeros, in ascending column, are the
    table's line of m in the order j = 0 … Nq − 1."""
    Wd, Wdiv = _operators(poly, torch.float64)
    for name, op in (("Wd", Wd), ("Wdiv", Wdiv)):
        tab = TABLES[name](op)
        blocks = _blocks(name, op).numpy()
        vals = tab.values.numpy()
        for a, s in enumerate(tab.strides):
            for m in range(blocks.shape[1]):
                i = (m // s) % tab.nq
                cols = m - i * s + s * np.arange(tab.nq)
                assert (np.diff(cols) > 0).all()
                nz = np.flatnonzero(blocks[a, m])
                assert set(nz) <= set(cols)
                np.testing.assert_array_equal(blocks[a, m, cols], vals[a, i])


@pytest.mark.parametrize("name", ("Wd", "Wdiv"))
def test_off_line_nonzero_raises(name):
    Wd, Wdiv = _operators(3, torch.float64)
    op = (Wd if name == "Wd" else Wdiv).clone()
    # node 1 and node 2·16 + 3·4 + 2 share no lattice line
    blocks = _blocks(name, op)
    blocks[0, 1, 2 * 16 + 3 * 4 + 2] = 1e-30
    with pytest.raises(ValueError, match="not a Kronecker line operator"):
        TABLES[name](op)
    # on its line, but a weight that differs from the other lines'
    op2 = (Wd if name == "Wd" else Wdiv).clone()
    _blocks(name, op2)[0, 16, 17] += 1.0
    with pytest.raises(ValueError, match="not a Kronecker line operator"):
        TABLES[name](op2)
    with pytest.raises(ValueError, match="Nq³"):
        line_ops(torch.zeros((1, 10, 10), dtype=torch.float64))


def test_table_built_once_per_operator_tensor():
    """The table is built once per tensor, kept while it lives, rebuilt
    after the tensor is written in place; an equal tensor has its own."""
    Wd, Wdiv = _operators(4, torch.float32)
    for name, op in (("Wd", Wd), ("Wdiv", Wdiv.clone())):
        tab = TABLES[name](op)
        assert TABLES[name](op) is tab
        other = op.clone()
        assert TABLES[name](other) is not tab
        op.mul_(2.0)
        tab2 = TABLES[name](op)
        assert tab2 is not tab
        torch.testing.assert_close(tab2.values, 2.0 * tab.values, rtol=0,
                                   atol=0)
        torch.testing.assert_close(tab2.dense(), _blocks(name, op), rtol=0,
                                   atol=0)


def _gather(tab, x):
    """out[..., a, m] = Σ_j values[a, i(m), j] · x[..., base(m) + j·s_a]
    in ascending j, as the kernels sum."""
    Np = x.shape[-1]
    m = torch.arange(Np)
    out = []
    for a, s in enumerate(tab.strides):
        i = (m // s) % tab.nq
        base = m - i * s
        acc = torch.zeros_like(x)
        for j in range(tab.nq):
            acc = acc + tab.values[a, i, j] * x[..., base + j * s]
        out.append(acc)
    return torch.stack(out, dim=-2)


@pytest.mark.parametrize("poly", (3, 4))
def test_gather_through_tables_equals_dense_matmul(poly):
    Wd, Wdiv = _operators(poly, torch.float64)
    Np = Wdiv.shape[0]
    rng = np.random.default_rng(poly)
    x = torch.as_tensor(rng.standard_normal((6, 4, Np)))
    # the chain's derivative d_a = x · Wd[a]
    dense = torch.stack([torch.matmul(x, Wd[a]) for a in range(2)], dim=-2)
    got = _gather(wd_lines(Wd), x)
    assert (got - dense).abs().max() <= 1e-13 * dense.abs().max()
    # the weak divergence Wdiv · mf, mf = concat_a mf_a
    mf = torch.as_tensor(rng.standard_normal((6, 5, 3 * Np)))
    dense = torch.matmul(mf, Wdiv.T)
    parts = _gather(wdiv_lines(Wdiv), mf.reshape(6, 5, 3, Np))
    got = parts[..., 0, 0, :] + parts[..., 1, 1, :] + parts[..., 2, 2, :]
    assert (got - dense).abs().max() <= 1e-13 * dense.abs().max()


def test_order_check_matches_the_cuda_dispatch():
    """KERNEL_NQ is the list of orders by_order instantiates: each case
    Np = Nq³ maps to integral_constant<int, Nq>, and the wrappers' check
    accepts those Np and refuses the others."""
    src = (Path(__file__).resolve().parents[1] / "climatemachine_tpu_torch"
           / "csrc" / "tile_pipeline.cuh").read_text()
    cases = re.findall(r"case (\d+): return f\(std::integral_constant<int, "
                       r"(\d+)>\(\)\);", src)
    assert sorted((int(np_), int(nq)) for np_, nq in cases) == \
        [(nq ** 3, nq) for nq in KERNEL_NQ]
    for nq in KERNEL_NQ:
        check_kernel_order("volume", nq ** 3)
    for Np in (1, 100, 343, 512):
        with pytest.raises(ValueError, match="built for Np = Nq³"):
            check_kernel_order("volume", Np)
