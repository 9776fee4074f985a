"""Hyperdiffusion LDG chain (grad → div → grad) as four kernels: hand-
written CUDA for Hopper and their plain PyTorch versions (port of
``climatemachine_tpu/dg/pallas_ldg.py`` ``chain_vm`` :166-257, bodies
``_k_first`` :68, ``_k_grad_to_div`` :77, ``_k_div_to_grad`` :101,
``_k_last`` :115).

- K1 :func:`ldg_first`: x → volume gradient and minus-side face rows;
- K2 :func:`ldg_grad_to_div`: pass-1 lift → gradient → volume divergence
  and n·v face scalars;
- K3 :func:`ldg_div_to_grad`: pass-2 lift → Laplacian → its volume
  gradient and face rows;
- K4 :func:`ldg_last`: pass-3 lift → ∇Δ ``[E, 3, n, Np]``.

Between them plain PyTorch does the three face-row exchanges
(ldg_tables.exchange) and the jump arithmetic, as the JAX package
leaves them to XLA.

Dispatch is by device: a CPU tensor takes the plain version (the JAX
bodies' arithmetic, with the dense 0/1 ``Sel`` and ``LT``); any other
tensor takes the kernel (csrc/ldg_chain.cu) or raises.  The kernels
apply ``Sel`` and ``LT`` as index gathers from
:class:`~climatemachine_tpu_torch.dg.ldg_tables.FaceOps` and cover
float32, n = 4 rows (u_h, h_tot) or n = 5 (with EquilMoistBiharmonic's
q_tot), nd = 2 directions (horizontal) and
p1-p5 (:data:`~climatemachine_tpu_torch.dg.line_ops.KERNEL_NQ`); they
stage their inputs in persistent blocks and K1-K3 are sum-factorised:
they read ``Wd`` only through its line table
(:func:`~climatemachine_tpu_torch.dg.line_ops.wd_lines`, which raises on
an operator that is not a Kronecker line operator).  Each wrapper counts
its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from climatemachine_tpu_torch import cuda_build
from climatemachine_tpu_torch.dg.ldg_tables import (FaceOps, W_for, exchange,
                                                    geom, tables)
from climatemachine_tpu_torch.dg.line_ops import (check_kernel_order,
                                                  wd_lines)


@dataclass
class ChainOperators:
    """Static operands of the chain on one grid, built once: the
    exchange tables (with the face operators, :attr:`fo`), ``Wd [nd, Np,
    Np]`` (Wd[a][k][m] = ∂_a weight of node k at node m), ξ ``[E, nd·3,
    Np]`` (slot 3·ai + c), sM ``[E, F]``, w3 = sM·n and the normals
    ``[E, 3, F]``, MI ``[E, Np]`` and the wall sign ``[E, 1, F]``."""
    dims: Tuple[int, ...]
    faces: Tuple[int, ...]
    tab: dict
    Wd: torch.Tensor
    xi: torch.Tensor
    sM: torch.Tensor
    w3: torch.Tensor
    nrm: torch.Tensor
    MI: torch.Tensor
    sign: torch.Tensor

    @property
    def fo(self) -> FaceOps:
        return self.tab["fo"]


def chain_operators(grid, dims, faces) -> ChainOperators:
    tab = tables(grid, faces)
    sM, nrm, xi, _ = geom(grid, faces, dims)
    E, Np, nd = grid.nelem, grid.Np, len(dims)
    Wd = W_for(grid, dims).reshape(nd, Np, Np).transpose(1, 2).contiguous()
    return ChainOperators(
        dims=tuple(dims), faces=tuple(faces), tab=tab, Wd=Wd,
        xi=xi.reshape(E, nd * 3, Np), sM=sM.reshape(E, -1),
        w3=(sM * nrm).contiguous(), nrm=nrm, MI=grid.MI,
        sign=tab["sign"][:, None, :])


# --- plain versions (the JAX kernel bodies) ----------------------------------

def _grad_part(x2, xi, Wd, Sel, E):
    """x2 ``[E·n, Np]`` → (vol ``[E, 3, n, Np]``, rows ``[E, n, F]``)."""
    n, Np = x2.shape[0] // E, x2.shape[1]
    nd = Wd.shape[0]
    rows = torch.matmul(x2, Sel)
    d = [torch.matmul(x2, Wd[ai]).reshape(E, n, Np) for ai in range(nd)]
    vol = []
    for c in range(3):
        acc = xi[:, c][:, None, :] * d[0]
        for ai in range(1, nd):
            acc = acc + xi[:, ai * 3 + c][:, None, :] * d[ai]
        vol.append(acc)
    return torch.stack(vol, dim=1), rows.reshape(E, n, -1)


def _lift(prod, LT, MI, base):
    """base + MI · (prod ``[E, R, F]`` · LT), ``[E, R, Np]``."""
    E, R, F = prod.shape
    corr = torch.matmul(prod.reshape(E * R, F), LT).reshape(E, R, -1)
    return base + MI[:, None, :] * corr


def ldg_first_plain(x, xi, Wd, fo):
    E, n, Np = x.shape
    return _grad_part(x.reshape(E * n, Np), xi, Wd, fo.Sel, E)


def ldg_grad_to_div_plain(vol1, dj, w3, nrm, MI, xi, Wd, fo):
    E, _, n, Np = vol1.shape
    prod = w3[:, :, None, :] * dj[:, None, :, :]           # [E, 3, n, F]
    grad = _lift(prod.reshape(E, 3 * n, -1), fo.LT, MI,
                 vol1.reshape(E, 3 * n, Np))
    g2 = grad.reshape(E * 3 * n, Np)
    div = torch.zeros((E, n, Np), dtype=vol1.dtype, device=vol1.device)
    for ai in range(Wd.shape[0]):
        dv = torch.matmul(g2, Wd[ai]).reshape(E, 3, n, Np)
        for c in range(3):
            div = div + xi[:, ai * 3 + c][:, None, :] * dv[:, c]
    rows3 = torch.matmul(g2, fo.Sel).reshape(E, 3, n, -1)
    s = (nrm[:, 0][:, None, :] * rows3[:, 0]
         + nrm[:, 1][:, None, :] * rows3[:, 1]
         + nrm[:, 2][:, None, :] * rows3[:, 2])
    return div, s


def ldg_div_to_grad_plain(div, dj2, sM, MI, xi, Wd, fo):
    E, n, Np = div.shape
    lap = _lift(sM[:, None, :] * dj2, fo.LT, MI, div)
    return _grad_part(lap.reshape(E * n, Np), xi, Wd, fo.Sel, E)


def ldg_last_plain(vol3, dj3, w3, MI, fo):
    E, _, n, Np = vol3.shape
    prod = w3[:, :, None, :] * dj3[:, None, :, :]
    return _lift(prod.reshape(E, 3 * n, -1), fo.LT, MI,
                 vol3.reshape(E, 3 * n, Np)).reshape(E, 3, n, Np)


# --- kernel wrappers ------------------------------------------------------------

@functools.cache
def _library():
    lib = cuda_build.load("ldg_chain")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ldg_first_f32.argtypes = ([ptr] * 3 + [i32] * 2 + [ptr] * 3
                                  + [i32] * 5 + [ptr])
    lib.ldg_grad_to_div_f32.argtypes = ([ptr] * 6 + [i32] + [ptr] * 2
                                        + [i32] * 2 + [ptr] * 3
                                        + [i32] * 5 + [ptr])
    lib.ldg_div_to_grad_f32.argtypes = ([ptr] * 5 + [i32] + [ptr] * 2
                                        + [i32] * 2 + [ptr] * 3
                                        + [i32] * 5 + [ptr])
    lib.ldg_last_f32.argtypes = [ptr] * 5 + [i32, ptr] + [i32] * 4 + [ptr]
    for fn in ("ldg_first_f32", "ldg_grad_to_div_f32",
               "ldg_div_to_grad_f32", "ldg_last_f32"):
        getattr(lib, fn).restype = ctypes.c_int
    lib.ldg_error_string.argtypes = [i32]
    lib.ldg_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_args(name, ref, n, nd, fo, **tensors):
    """Refuse what the kernel does not cover: n other than 4 or 5 rows,
    nd other than 2 directions where a derivative runs (nd is None for
    K4), a tensor off CUDA, not float32, misshapen or not contiguous."""
    if n not in (4, 5) or nd not in (None, 2):
        raise NotImplementedError(
            f"the CUDA {name} kernel covers n=4 or n=5 rows and nd=2 "
            f"directions, got n={n}, nd={nd}")
    if ref.device.type != "cuda":
        raise ValueError(f"the {name} kernel runs on CUDA tensors, got "
                         f"{ref.device}")
    for key, (t, shape) in tensors.items():
        if t.device != ref.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name} {key}: need a contiguous float32 {shape} tensor on "
                f"{ref.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    for t in (fo.sel_idx, fo.lift_idx):
        if t.device != ref.device:
            raise ValueError(f"{name}: face tables on {t.device}, need "
                             f"{ref.device}")


def _launch(name, fn, *args):
    lib = _library()
    stream = torch.cuda.current_stream(args[0].device).cuda_stream
    with torch.cuda.device(args[0].device):
        code = getattr(lib, fn)(*[a.data_ptr() if isinstance(a, torch.Tensor)
                                  else a for a in args], stream)
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.ldg_error_string(code).decode())


def ldg_first(x, xi, Wd, fo):
    """K1: x ``[E, n, Np]``, ξ ``[E, nd·3, Np]``, Wd ``[nd, Np, Np]`` →
    (vol ``[E, 3, n, Np]``, rows ``[E, n, F]``)."""
    if x.device.type == "cpu":
        return ldg_first_plain(x, xi, Wd, fo)
    E, n, Np = x.shape
    nd, F = Wd.shape[0], fo.F
    _check_kernel_args("ldg_first", x, n, nd, fo, x=(x, (E, n, Np)),
                       xi=(xi, (E, nd * 3, Np)), Wd=(Wd, (nd, Np, Np)))
    check_kernel_order("ldg_first", Np)
    lines = wd_lines(Wd)
    cuda_build.check_aligned("ldg_first", x=x, xi=xi)
    vol = torch.empty((E, 3, n, Np), dtype=x.dtype, device=x.device)
    rows = torch.empty((E, n, F), dtype=x.dtype, device=x.device)
    _launch("ldg_first", "ldg_first_f32", x, xi, lines.values,
            *lines.strides, fo.sel_idx, vol, rows, E, n, nd, Np, F)
    ldg_first.launches += 1
    return vol, rows


def ldg_grad_to_div(vol1, dj, w3, nrm, MI, xi, Wd, fo):
    """K2: vol1 ``[E, 3, n, Np]``, dj ``[E, n, F]``, w3/nrm ``[E, 3, F]``,
    MI ``[E, Np]`` → (div ``[E, n, Np]``, s ``[E, n, F]``)."""
    if vol1.device.type == "cpu":
        return ldg_grad_to_div_plain(vol1, dj, w3, nrm, MI, xi, Wd, fo)
    E, _, n, Np = vol1.shape
    nd, F = Wd.shape[0], fo.F
    _check_kernel_args("ldg_grad_to_div", vol1, n, nd, fo,
                       vol1=(vol1, (E, 3, n, Np)), dj=(dj, (E, n, F)),
                       w3=(w3, (E, 3, F)), nrm=(nrm, (E, 3, F)),
                       MI=(MI, (E, Np)), xi=(xi, (E, nd * 3, Np)),
                       Wd=(Wd, (nd, Np, Np)))
    check_kernel_order("ldg_grad_to_div", Np)
    lines = wd_lines(Wd)
    div = torch.empty((E, n, Np), dtype=vol1.dtype, device=vol1.device)
    s = torch.empty((E, n, F), dtype=vol1.dtype, device=vol1.device)
    cuda_build.check_aligned("ldg_grad_to_div", vol1=vol1, dj=dj, w3=w3,
                             nrm=nrm, MI=MI, xi=xi)
    _launch("ldg_grad_to_div", "ldg_grad_to_div_f32", vol1, dj, w3, nrm, MI,
            fo.lift_idx, fo.lift_idx.shape[1], xi, lines.values,
            *lines.strides, fo.sel_idx, div, s, E, n, nd, Np, F)
    ldg_grad_to_div.launches += 1
    return div, s


def ldg_div_to_grad(div, dj2, sM, MI, xi, Wd, fo):
    """K3: div ``[E, n, Np]``, dj2 ``[E, n, F]``, sM ``[E, F]`` →
    (vol ``[E, 3, n, Np]``, rows ``[E, n, F]``)."""
    if div.device.type == "cpu":
        return ldg_div_to_grad_plain(div, dj2, sM, MI, xi, Wd, fo)
    E, n, Np = div.shape
    nd, F = Wd.shape[0], fo.F
    _check_kernel_args("ldg_div_to_grad", div, n, nd, fo,
                       div=(div, (E, n, Np)), dj2=(dj2, (E, n, F)),
                       sM=(sM, (E, F)), MI=(MI, (E, Np)),
                       xi=(xi, (E, nd * 3, Np)), Wd=(Wd, (nd, Np, Np)))
    check_kernel_order("ldg_div_to_grad", Np)
    lines = wd_lines(Wd)
    cuda_build.check_aligned("ldg_div_to_grad", div=div, dj2=dj2, sM=sM,
                             MI=MI, xi=xi)
    vol = torch.empty((E, 3, n, Np), dtype=div.dtype, device=div.device)
    rows = torch.empty((E, n, F), dtype=div.dtype, device=div.device)
    _launch("ldg_div_to_grad", "ldg_div_to_grad_f32", div, dj2, sM, MI,
            fo.lift_idx, fo.lift_idx.shape[1], xi, lines.values,
            *lines.strides, fo.sel_idx, vol, rows, E, n, nd, Np, F)
    ldg_div_to_grad.launches += 1
    return vol, rows


def ldg_last(vol3, dj3, w3, MI, fo):
    """K4: vol3 ``[E, 3, n, Np]``, dj3 ``[E, n, F]``, w3 ``[E, 3, F]`` →
    ∇Δ ``[E, 3, n, Np]``."""
    if vol3.device.type == "cpu":
        return ldg_last_plain(vol3, dj3, w3, MI, fo)
    E, _, n, Np = vol3.shape
    F = fo.F
    _check_kernel_args("ldg_last", vol3, n, None, fo,
                       vol3=(vol3, (E, 3, n, Np)), dj3=(dj3, (E, n, F)),
                       w3=(w3, (E, 3, F)), MI=(MI, (E, Np)))
    check_kernel_order("ldg_last", Np)
    cuda_build.check_aligned("ldg_last", vol3=vol3, dj3=dj3, w3=w3, MI=MI)
    out = torch.empty_like(vol3)
    _launch("ldg_last", "ldg_last_f32", vol3, dj3, w3, MI, fo.lift_idx,
            fo.lift_idx.shape[1], out, E, n, Np, F)
    ldg_last.launches += 1
    return out


for _k in (ldg_first, ldg_grad_to_div, ldg_div_to_grad, ldg_last):
    _k.launches = 0

KERNELS = (ldg_first, ldg_grad_to_div, ldg_div_to_grad, ldg_last)
PLAIN = (ldg_first_plain, ldg_grad_to_div_plain, ldg_div_to_grad_plain,
         ldg_last_plain)


# --- the chain ---------------------------------------------------------------------

def face_jump(rows, ops: ChainOperators, signed: bool = False):
    """½(neighbour − own) face values ``[E, n, F]``; ``signed`` flips the
    neighbour on wall faces (the n·v scalars of the divergence pass)."""
    nbr = exchange(rows, ops.tab)
    return 0.5 * ((ops.sign * nbr if signed else nbr) - rows)


def chain_vm(xv, ops: ChainOperators, stages=KERNELS):
    """xv ``[E, n, Np]`` → ∇Δ ``[E, 3, n, Np]`` through the four stages
    (the kernel wrappers by default; :data:`PLAIN` for the plain
    versions on any device)."""
    first, to_div, to_grad, last = stages
    vol1, rows1 = first(xv, ops.xi, ops.Wd, ops.fo)
    div, s = to_div(vol1, face_jump(rows1, ops), ops.w3, ops.nrm, ops.MI,
                    ops.xi, ops.Wd, ops.fo)
    vol3, rows3 = to_grad(div, face_jump(s, ops, signed=True), ops.sM,
                          ops.MI, ops.xi, ops.Wd, ops.fo)
    return last(vol3, face_jump(rows3, ops), ops.w3, ops.MI, ops.fo)
