"""Fused var-major volume tendency: a hand-written CUDA kernel for Hopper
and its plain PyTorch version (port of
``climatemachine_tpu/dg/pallas_volume.py`` ``fused_volume_tendency_vm``
:264, body ``_kernel_vm`` :153-256).

    out[e, v, :] = MI · Wdiv · concat_a(M · Σ_i ξ[a, i] · F_i[v])

F is the Euler flux from the state and the precomputed pressure (with
the reference pressure taken out of the momentum flux where
``subtract_ref``), optionally plus
the hyperdiffusive flux F₂ and minus the linear acoustic(-gravity) flux
on ``lin_dims``.

Dispatch is by device: a CPU tensor takes :func:`volume_tendency_plain`;
any other tensor takes the kernel (csrc/volume_vm.cu) or raises.  The
kernel covers what the Held-Suarez step, the moist baroclinic wave and
their fused remainders and the isentropic vortex run: float32, ``nq=5``
(dry) or ``nq=6`` (EquilMoist, ρq_tot advected), with and without
``subtract_ref``, with or without the F₂ of DryBiharmonic (``ngl=4``) or
EquilMoistBiharmonic (``ngl=5``, with ν₄_q): ``ngl = nq − 1``;
``lin_dims`` () or, for a remainder in "vertical", "horizontal" or
"every", (2,), (0, 1) or (0, 1, 2), with or without ``lin_gravity``.  It
refuses ``ngl ≠ nq − 1`` and a ``lin_dims`` no direction yields.  The
plain version covers the whole signature.

The kernel is compiled at first use (cuda_build.py) and called through
ctypes on PyTorch's current stream.  It is sum-factorised: it reads
Wdiv only through its line table
(:func:`~climatemachine_tpu_torch.dg.line_ops.wdiv_lines`, built once per
Wdiv tensor; it raises on an operator that is not a Kronecker line
operator), as the generic operator's dry kernel
(dg/dry_volume_kernel.py, the same CUDA source) does, and covers p1-p5
(:data:`~climatemachine_tpu_torch.dg.line_ops.KERNEL_NQ`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from climatemachine_tpu_torch import cuda_build
from climatemachine_tpu_torch.dg.line_ops import (check_kernel_order,
                                                  wdiv_lines)


def volume_tendency_plain(qv, p, phi, p_ref, ref3, gl2, nu, xiv, M, MI,
                          Wdiv, nq: int, ngl: int, R_d: float, cv_d: float,
                          T_0: float, subtract_ref: bool = True,
                          has_f2: bool = False, lin_dims: tuple = (),
                          lin_gravity: bool = True):
    """Plain PyTorch version, same arguments and arithmetic order as the
    JAX kernel body.  ``ref3`` is read only with ``lin_dims``, ``gl2``
    and ``nu`` only with ``has_f2``."""
    E, _, Np = qv.shape
    rho = qv[:, 0]
    ru = (qv[:, 1], qv[:, 2], qv[:, 3])
    rhoe = qv[:, 4]
    inv_rho = 1.0 / rho
    u = (ru[0] * inv_rho, ru[1] * inv_rho, ru[2] * inv_rho)
    p_eff = p - p_ref if subtract_ref else p
    h = rhoe + p

    def F(i, v):
        if v == 0:
            return ru[i]
        if v in (1, 2, 3):
            f = ru[v - 1] * u[i]
            return f + p_eff if v - 1 == i else f
        if v == 4:
            return h * u[i]
        return qv[:, v] * u[i]                   # advected scalars

    def F2(i, v):
        """Hyperdiffusive flux from gl2 = ∇Δ(u_h, h_tot[, q_tot])."""
        nu4 = nu[:, 0]
        rnu = rho * nu4
        g = lambda j: gl2[:, i * ngl + j]
        if v in (1, 2, 3):
            return rnu * g(v - 1)
        if v == 4:
            return nu4 * (ru[0] * g(0) + ru[1] * g(1)
                          + ru[2] * g(2)) + rnu * g(3)
        if v == 5 and ngl >= 5:
            return rho * nu[:, 1] * g(4)
        return None

    def Flin(i, v):
        """Linear acoustic(-gravity) flux."""
        pL = rho * R_d * T_0 + (R_d / cv_d) * (rhoe - rho * phi)
        if v == 0:
            return ru[i]
        if v in (1, 2, 3):
            return pL if v - 1 == i else None
        if v == 4:
            coeff = (ref3[:, 0] + ref3[:, 2]) / ref3[:, 1]
            if not lin_gravity:
                coeff = coeff - phi
            return coeff * ru[i]
        return None

    parts = []
    for v in range(nq):
        for a in range(3):
            acc = xiv[:, 3 * a] * F(0, v)
            acc = acc + xiv[:, 3 * a + 1] * F(1, v)
            acc = acc + xiv[:, 3 * a + 2] * F(2, v)
            if a in lin_dims:
                for i in range(3):
                    if not (v in (1, 2, 3) and i != v - 1):
                        fl = Flin(i, v)
                        if fl is not None:
                            acc = acc - xiv[:, 3 * a + i] * fl
            if has_f2:
                for i in range(3):
                    f2 = F2(i, v)
                    if f2 is not None:
                        acc = acc + xiv[:, 3 * a + i] * f2
            parts.append(M * acc)
    mf = torch.stack(parts, dim=1).reshape(E, nq, 3 * Np)
    return MI[:, None, :] * torch.matmul(mf, Wdiv.T)


#: the ``lin_dims`` the kernels are built for: none, and the dims of a
#: remainder in "vertical", "horizontal" or "every" (no direction yields
#: another set)
KERNEL_LIN_DIMS = ((), (2,), (0, 1), (0, 1, 2))


def lin_mask(lin_dims) -> int:
    """``lin_dims`` as the kernels' bit mask (bit a for direction a)."""
    return sum(1 << a for a in lin_dims)


@functools.cache
def _library():
    lib = cuda_build.load("volume_vm")
    lib.volume_vm_f32.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_int] * 10 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    lib.volume_vm_f32.restype = ctypes.c_int
    lib.dry_volume_f32.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int] * 8 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
    lib.dry_volume_f32.restype = ctypes.c_int
    lib.volume_vm_error_string.argtypes = [ctypes.c_int]
    lib.volume_vm_error_string.restype = ctypes.c_char_p
    return lib


def launch(fn_name: str, ref, *args):
    """Call ``fn_name`` of the library on ``ref``'s device and current
    stream with ``args`` and the stream; raise if the launch failed."""
    lib = _library()
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        code = getattr(lib, fn_name)(*args, stream)
    if code != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: "
                           + lib.volume_vm_error_string(code).decode())


def _check_kernel_args(qv, p, phi, p_ref, ref3, gl2, nu, xiv, M, MI, Wdiv,
                       nq, ngl, subtract_ref, has_f2, lin_dims):
    if nq not in (5, 6) or (has_f2 and ngl != nq - 1) \
            or tuple(lin_dims) not in KERNEL_LIN_DIMS:
        raise NotImplementedError(
            "the CUDA volume kernel covers nq=5 or 6, lin_dims in "
            f"{KERNEL_LIN_DIMS} and has_f2 with ngl=nq-1 (got nq={nq}, "
            f"has_f2={has_f2}, ngl={ngl}, lin_dims={lin_dims})")
    E, _, Np = qv.shape
    shapes = {"p": (p, (E, Np))}
    if subtract_ref:
        shapes["p_ref"] = (p_ref, (E, Np))
    if has_f2:
        shapes.update(gl2=(gl2, (E, 3 * ngl, Np)), nu=(nu, (E, 2, Np)))
    if lin_dims:
        shapes.update(phi=(phi, (E, Np)), ref3=(ref3, (E, 3, Np)))
    check_tensors(qv, xiv, M, MI, Wdiv, nq=nq, **shapes)


def check_tensors(qv, xiv, M, MI, Wdiv, nq: int = 5, **more):
    """Raise ValueError unless qv ``[E, nq, Np]`` is a CUDA tensor of an
    order the kernels are built for and it, the common operands and
    ``more`` (name → (tensor, shape)) are contiguous, 16-byte aligned
    float32 tensors of their shapes on its device."""
    if qv.device.type != "cuda":
        raise ValueError(f"the volume kernels run on CUDA tensors, got "
                         f"{qv.device}")
    E, _, Np = qv.shape
    check_kernel_order("volume", Np)
    shapes = {"qv": (qv, (E, nq, Np)), "xiv": (xiv, (E, 9, Np)),
              "M": (M, (E, Np)), "MI": (MI, (E, Np)),
              "Wdiv": (Wdiv, (Np, 3 * Np)), **more}
    for name, (t, shape) in shapes.items():
        if t.device != qv.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous float32 {shape} tensor on "
                f"{qv.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    cuda_build.check_aligned("volume",
                             **{name: t for name, (t, _) in shapes.items()})


def fused_volume_tendency_vm(qv, p, phi, p_ref, ref3, gl2, nu, xiv, M, MI,
                             Wdiv, nq: int, ngl: int, R_d: float,
                             cv_d: float, T_0: float,
                             subtract_ref: bool = True,
                             has_f2: bool = False, lin_dims: tuple = (),
                             lin_gravity: bool = True):
    """Var-major volume tendency ``[E, nq, Np]``: qv ``[E, nq, Np]``,
    p/phi/p_ref/M/MI ``[E, Np]``, ref3 ``[E, 3, Np]`` (ref ρe, ρ, p; phi
    and ref3 read only with ``lin_dims``, p_ref only with
    ``subtract_ref``), gl2 ``[E, 3·ngl, Np]`` with nu
    ``[E, 2, Np]`` (ν₄, ν₄_q), xiv ``[E, 9, Np]`` (ξ_a,ᵢ at 3a+i), Wdiv
    ``[Np, 3Np]``.

    CPU tensors take the plain version; otherwise the CUDA kernel runs
    and ``fused_volume_tendency_vm.launches`` counts it."""
    if qv.device.type == "cpu":
        return volume_tendency_plain(
            qv, p, phi, p_ref, ref3, gl2, nu, xiv, M, MI, Wdiv, nq=nq,
            ngl=ngl, R_d=R_d, cv_d=cv_d, T_0=T_0, subtract_ref=subtract_ref,
            has_f2=has_f2, lin_dims=lin_dims, lin_gravity=lin_gravity)
    lin_dims = tuple(lin_dims)
    _check_kernel_args(qv, p, phi, p_ref, ref3, gl2, nu, xiv, M, MI, Wdiv,
                       nq, ngl, subtract_ref, has_f2, lin_dims)
    E, _, Np = qv.shape
    lines = wdiv_lines(Wdiv)
    out = torch.empty_like(qv)
    launch("volume_vm_f32", qv, qv.data_ptr(), p.data_ptr(),
           phi.data_ptr() if lin_dims else None,
           p_ref.data_ptr() if subtract_ref else None,
           ref3.data_ptr() if lin_dims else None, xiv.data_ptr(),
           M.data_ptr(), MI.data_ptr(), gl2.data_ptr() if has_f2 else None,
           nu.data_ptr() if has_f2 else None, lines.values.data_ptr(),
           out.data_ptr(), E, Np, nq, int(has_f2), lin_mask(lin_dims),
           int(lin_gravity), int(subtract_ref), *lines.strides, R_d, T_0,
           R_d / cv_d)
    fused_volume_tendency_vm.launches += 1
    return out


fused_volume_tendency_vm.launches = 0
