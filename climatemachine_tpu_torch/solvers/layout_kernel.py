"""Var-major grid state ↔ column blocks: hand-written CUDA kernels for
Hopper and their plain PyTorch versions (port of
``climatemachine_tpu/solvers/pallas_layout.py`` ``to_blocks_vm`` :43,
body ``_k_to_blocks`` :30-33, and ``from_blocks_vm`` :70, body
``_k_from_blocks`` :36-38).

    y[ev, (k, v), (eh, ji)] = x[(eh, ev), v, (k, ji)]

with ``layout_dims = (Eh, nv, nvars, Nq3, ji)``: x is the var-major
state ``[E = Eh·nv, nvars, Np = Nq3·ji]`` of a stacked grid (element
``e = eh·nv + ev``, node ``k·ji + (j, i)``), y the columnwise solver's
block layout ``[nv, Nq3·nvars, Eh·ji]``.  :func:`from_blocks_vm` is the
inverse.  A pure permutation: the results equal the plain versions bit
for bit.

Dispatch is by device: a CPU tensor takes the plain version; any other
tensor takes the kernel (csrc/column_layout.cu) or raises.  The kernels
cover float32; each wrapper counts its launches in ``.launches``.  The
kernel's dims (nvars, Nq3, ji) are compile-time constants at the three
shapes the port's IMEX paths run, (5, 5, 25) dry, (6, 5, 25) moist and
(9, 5, 25) moist with warm rain and two tracers, and runtime values at
any other; :func:`to_blocks_vm_runtime_dims` and
:func:`from_blocks_vm_runtime_dims` take the runtime-dims kernel at every
shape, so that both branches can be held at one shape (they count no
launches: no path runs them).  They
are compiled at first use (cuda_build.py) and called through ctypes on
PyTorch's current stream, inside the tensor's device; the launch makes
no device query.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from climatemachine_tpu_torch import cuda_build


def to_blocks_vm_plain(x, layout_dims):
    """The reshape → permute → reshape of the JAX ``VMColumnLayout``."""
    Eh, nv, nvars, Nq3, ji = layout_dims
    xb = x.reshape(Eh, nv, nvars, Nq3, ji).permute(1, 3, 2, 0, 4)
    return xb.reshape(nv, Nq3 * nvars, Eh * ji)


def from_blocks_vm_plain(yb, layout_dims):
    Eh, nv, nvars, Nq3, ji = layout_dims
    xb = yb.reshape(nv, Nq3, nvars, Eh, ji).permute(3, 0, 2, 1, 4)
    return xb.reshape(Eh * nv, nvars, Nq3 * ji)


@functools.cache
def _library():
    lib = cuda_build.load("column_layout")
    for fn in ("to_blocks_f32", "from_blocks_f32", "to_blocks_runtime_f32",
               "from_blocks_runtime_f32"):
        getattr(lib, fn).argtypes = ([ctypes.c_void_p] * 2
                                     + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        getattr(lib, fn).restype = ctypes.c_int
    lib.column_layout_error_string.argtypes = [ctypes.c_int]
    lib.column_layout_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name, src, shape, layout_dims):
    """Check ``src``, allocate the output of ``shape`` and launch
    ``<name>_f32`` on it."""
    if src.device.type != "cuda":
        raise ValueError(f"the {name} kernel runs on CUDA tensors, got "
                         f"{src.device}")
    if src.dtype != torch.float32 or not src.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 tensor, got "
                         f"{src.dtype} contiguous={src.is_contiguous()}")
    Eh, nv, nvars, Nq3, ji = layout_dims
    if src.numel() != Eh * nv * nvars * Nq3 * ji:
        raise ValueError(f"{name}: {tuple(src.shape)} does not hold "
                         f"layout_dims {layout_dims}")
    lib = _library()
    out = torch.empty(shape, dtype=src.dtype, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        code = getattr(lib, f"{name}_f32")(src.data_ptr(), out.data_ptr(),
                                           Eh, nv, nvars, Nq3, ji, stream)
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.column_layout_error_string(code).decode())
    return out


def to_blocks_vm(x, layout_dims):
    """x ``[E, nvars, Np]`` → ``[nv, Nq3·nvars, Eh·ji]``."""
    if x.device.type == "cpu":
        return to_blocks_vm_plain(x, layout_dims)
    Eh, nv, nvars, Nq3, ji = layout_dims
    out = _launch("to_blocks", x, (nv, Nq3 * nvars, Eh * ji), layout_dims)
    to_blocks_vm.launches += 1
    return out


def from_blocks_vm(yb, layout_dims):
    """yb ``[nv, Nq3·nvars, Eh·ji]`` → ``[E, nvars, Np]``."""
    if yb.device.type == "cpu":
        return from_blocks_vm_plain(yb, layout_dims)
    Eh, nv, nvars, Nq3, ji = layout_dims
    out = _launch("from_blocks", yb, (Eh * nv, nvars, Nq3 * ji),
                  layout_dims)
    from_blocks_vm.launches += 1
    return out


def to_blocks_vm_runtime_dims(x, layout_dims):
    """:func:`to_blocks_vm` through the runtime-dims kernel, on CUDA."""
    Eh, nv, nvars, Nq3, ji = layout_dims
    return _launch("to_blocks_runtime", x, (nv, Nq3 * nvars, Eh * ji),
                   layout_dims)


def from_blocks_vm_runtime_dims(yb, layout_dims):
    """:func:`from_blocks_vm` through the runtime-dims kernel, on CUDA."""
    Eh, nv, nvars, Nq3, ji = layout_dims
    return _launch("from_blocks_runtime", yb, (Eh * nv, nvars, Nq3 * ji),
                   layout_dims)


to_blocks_vm.launches = 0
from_blocks_vm.launches = 0
