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
  float64 within 1e-13 of max|dense|, at p1-p5;
- K1's and K3's contraction as the CUDA kernels compute it, through
  the tables the kernels build (each node's line base and position, the
  transposed lift table, sel) and their flat offsets, equals their plain
  versions
  (``ldg_first_plain``, ``ldg_div_to_grad_plain``) in float64 within
  1e-13 of max|plain|, at p1-p5;
- K4's lift as the CUDA kernel computes it, tile by tile (4 elements a
  tile, the last one partial) on the flat runs of each tile's stage,
  through the transposed lift table with one accumulator a row in
  ascending slot, equals ``ldg_last_plain`` in float64 within 1e-13 of
  max|plain|, at p1-p5;
- the wrappers' order check accepts exactly the orders that the CUDA
  sources dispatch on (csrc/tile_pipeline.cuh:by_order).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from climatemachine_tpu_torch.dg import ldg_kernel
from climatemachine_tpu_torch.dg.ldg_tables import W_for
from climatemachine_tpu_torch.dg.line_ops import (KERNEL_NQ,
                                                  check_kernel_order,
                                                  line_ops, wd_lines,
                                                  wdiv_lines)
from climatemachine_tpu_torch.dg.spatial import (direction_dims,
                                                 direction_faces)
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


@pytest.mark.parametrize("poly", [nq - 1 for nq in KERNEL_NQ])
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


def _kernel_tables(lines, lift_idx, sel_idx):
    """K1's and K3's shared-memory tables as load_tables
    (csrc/ldg_chain.cu) fills them, as flat int tables: ``info[a·Np + m]
    = base | position << 16`` of node m's line along direction a, the
    lift table transposed ``liftT[l·Np + k] = lift[k·L + l]`` and
    ``sels``."""
    nq, Np, L = lines.nq, lines.nq ** 3, lift_idx.shape[1]
    i = torch.arange(len(lines.strides) * Np)
    a, m = i // Np, i % Np
    st = torch.tensor(lines.strides)[a]
    q = (m // st) % nq
    info = (m - q * st) | (q << 16)
    i = torch.arange(L * Np)
    l, k = i // Np, i % Np
    liftT = lift_idx.long().reshape(-1)[k * L + l]
    return info, liftT, sel_idx.long()


def _kernel_lift(div, dj2, sM, MI, liftT):
    """K3's prologue through the kernel's tables: lap[v][k] = div + MI[k]
    · Σ_l sM[f]·dj2[v][f] over f = liftT[l·Np + k] ≥ 0 in ascending l."""
    Np = div.shape[-1]
    acc = torch.zeros_like(div)
    for col in liftT.reshape(-1, Np):             # one slot l, all k
        ok = col >= 0
        f = col.clamp(min=0)
        acc = acc + torch.where(ok, sM[:, None, f] * dj2[..., f], 0.0)
    return div + MI[:, None, :] * acc


def _kernel_grad(x, xi, lines, info, sels):
    """K1 (and K3 after its prologue) through the kernel's tables and flat
    offsets: rows[i] = x[r·Np + sels[f]] for i = r·F + f, r = e·N + v;
    per direction a the weights ``lines[(a·Nq + (info >> 16))·Nq + j]``
    times x at ``(info & 0xffff) + j·strides[a]`` in ascending j;
    vol[c][v] = ξ[c]·d₀ + ξ[3+c]·d₁."""
    E, N, Np = x.shape
    nq, F = lines.nq, sels.shape[0]
    flat = x.reshape(E * N, Np)
    i = torch.arange(E * N * F)
    r, f = i // F, i % F
    rows = x.reshape(-1)[r * Np + sels[f]].reshape(E, N, F)
    w = lines.values.reshape(-1)
    d = []
    for a, s in enumerate(lines.strides):
        inf = info[a * Np:(a + 1) * Np]
        base, row = inf & 0xFFFF, (a * nq + (inf >> 16)) * nq
        acc = torch.zeros_like(flat)
        for j in range(nq):
            acc = acc + flat[:, base + j * s] * w[row + j]
        d.append(acc.reshape(E, N, Np))
    vol = torch.stack([xi[:, c, None] * d[0] + xi[:, 3 + c, None] * d[1]
                       for c in range(3)], dim=1)
    return vol, rows


CHAIN_CASES = [(stage, nq - 1) for stage in ("ldg_first", "ldg_div_to_grad")
               for nq in KERNEL_NQ]


@pytest.mark.parametrize("stage,poly", CHAIN_CASES,
                         ids=[f"{s}-p{p}" for s, p in CHAIN_CASES])
def test_chain_grad_through_lines_equals_plain(stage, poly):
    g = held_suarez_config(1, 1, poly, dtype=torch.float64,
                           hyperdiffusion_tau=None, device="cpu").grid
    ops = ldg_kernel.chain_operators(g, direction_dims("horizontal", 3),
                                     direction_faces("horizontal", 3))
    E, Np, F = g.nelem, g.Np, ops.fo.F
    rng = np.random.default_rng(poly)
    x = torch.as_tensor(rng.standard_normal((E, 4, Np)))
    if stage == "ldg_first":
        ref = ldg_kernel.ldg_first_plain(x, ops.xi, ops.Wd, ops.fo)
    else:
        dj2 = torch.as_tensor(rng.standard_normal((E, 4, F)))
        ref = ldg_kernel.ldg_div_to_grad_plain(x, dj2, ops.sM, ops.MI,
                                               ops.xi, ops.Wd, ops.fo)
    lines = wd_lines(ops.Wd)
    info, liftT, sels = _kernel_tables(lines, ops.fo.lift_idx,
                                       ops.fo.sel_idx)
    if stage == "ldg_div_to_grad":
        x = _kernel_lift(x, dj2, ops.sM, ops.MI, liftT)
    got = _kernel_grad(x, ops.xi, lines, info, sels)
    for o, r in zip(got, ref):
        assert o.shape == r.shape
        assert (o - r).abs().max() <= 1e-13 * r.abs().max()


TILE_E = 4        # csrc/ldg_chain.cu: elements a tile


def _kernel_last(vol3, dj3, w3, MI, liftT):
    """K4 (csrc/ldg_chain.cu:ldg_last_kernel, its lift lift_w3) as the
    kernel runs it: per tile of TILE_E elements (the last one partial) the
    stage's flat runs vol3 | dj3 | w3 | MI; one thread per (te, k) of the
    tile with 12 accumulators acc[c][v] += w3[(te·3 + c)·F + f] ·
    dj3[(te·N + v)·F + f] over f = liftT[l·Np + k] ≥ 0 in ascending slot
    l; then vol3[((te·3 + c)·N + v)·Np + k] += MI[te·Np + k] · acc[c][v]
    in place, and the tile's vol3 run is its out run."""
    E, _, N, Np = vol3.shape
    F = dj3.shape[-1]
    out = []
    for e0 in range(0, E, TILE_E):
        ne = min(TILE_E, E - e0)
        S_vol = vol3[e0:e0 + ne].reshape(-1).clone()
        S_dj, S_w3, S_mi = (a[e0:e0 + ne].reshape(-1) for a in (dj3, w3, MI))
        i = torch.arange(ne * Np)                 # the threads of the tile
        te, k = i // Np, i % Np
        acc = torch.zeros((3, N, ne * Np), dtype=vol3.dtype)
        for col in liftT.reshape(-1, Np):         # slot l, ascending
            f = col[k]
            ok = f >= 0
            f = f.clamp(min=0)
            for c in range(3):
                w = S_w3[(te * 3 + c) * F + f]
                for v in range(N):
                    acc[c, v] += torch.where(ok, w * S_dj[(te * N + v) * F + f],
                                             0.0)
        for c in range(3):
            for v in range(N):
                at = ((te * 3 + c) * N + v) * Np + k
                S_vol[at] = S_vol[at] + S_mi[te * Np + k] * acc[c, v]
        out.append(S_vol)
    return torch.cat(out).reshape(vol3.shape)


@pytest.mark.parametrize("poly", [nq - 1 for nq in KERNEL_NQ])
def test_last_lift_through_tiles_equals_plain(poly):
    g = held_suarez_config(1, 1, poly, dtype=torch.float64,
                           hyperdiffusion_tau=None, device="cpu").grid
    ops = ldg_kernel.chain_operators(g, direction_dims("horizontal", 3),
                                     direction_faces("horizontal", 3))
    E, Np, F = g.nelem, g.Np, ops.fo.F
    assert E % TILE_E                             # a partial last tile
    # every operand drawn per element, so that a wrong element offset shows
    # (the geometry's MI is the same on each element of this grid)
    rng = np.random.default_rng(poly)
    vol3, dj3, w3 = (torch.as_tensor(rng.standard_normal(shape)) for shape
                     in ((E, 3, 4, Np), (E, 4, F), (E, 3, F)))
    MI = torch.as_tensor(rng.uniform(0.5, 2.0, (E, Np)))
    ref = ldg_kernel.ldg_last_plain(vol3, dj3, w3, MI, ops.fo)
    _, liftT, _ = _kernel_tables(wd_lines(ops.Wd), ops.fo.lift_idx,
                                 ops.fo.sel_idx)
    got = _kernel_last(vol3, dj3, w3, MI, liftT)
    assert got.shape == ref.shape
    assert (got - ref).abs().max() <= 1e-13 * ref.abs().max()


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
