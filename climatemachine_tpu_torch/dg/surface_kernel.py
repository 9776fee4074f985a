"""Var-major surface pass as two kernels: hand-written CUDA for Hopper and
their plain PyTorch versions (port of
``climatemachine_tpu/dg/pallas_surface.py`` ``extract_trace_vm`` :77,
body ``_k_extract`` :38-72, and ``fused_surface_lift_vm`` :216, body
``_kernel`` :122-210).

- :func:`extract_trace_vm`: volume state → minus-side face bundle
  ``[E, nvb, X]``: the face extraction of q, p, c and the aux lanes and,
  with hyperdiffusion, the nq n·F₂ trace lanes built from the extracted
  ∇Δ lanes and ν;
- :func:`fused_surface_lift_vm`: the bundle and its gathered neighbour
  side → wall ghost, Rusanov flux, the interior hyperdiffusive correction,
  the optional linear-flux subtraction on the remainder's face lanes, sM
  scaling, the lift and −MI: the surface tendency ``[E, nq, Np]``.

Bundle lanes (the lane contract of dg/fast_rhs.py): q (nq), p, c, aux (na:
none without a reference pressure to take out and no remainder, else
p_ref, then for a fused remainder φ, the linear energy coefficient and the
linear sound speed), then with hyperdiffusion the nq n·F₂ trace lanes.
The neighbour gather between the two kernels stays plain PyTorch
(dg/fast_surface.py), as the JAX package leaves it to XLA.

Dispatch is by device: a CPU tensor takes the plain version (the JAX
bodies' arithmetic, in their order, with the dense extraction matrix
``lift [Np, X]`` and its transpose); any other tensor takes the kernel
(csrc/surface_vm.cu) or raises.  The kernels take the 0/1 extraction
matrix as the index tables of :func:`face_tables` instead of multiplying
by it, and cover what the Held-Suarez step, the moist baroclinic wave,
their fused remainders and the isentropic vortex run: float32, ``nq=5``
or ``nq=6`` (EquilMoist), with (``ngl = nq − 1``) or without
hyperdiffusion; the bundles of dg/fast_rhs.py: ``na=0`` (nothing reads
p_ref: a reference state that does not subtract, no remainder), ``na=1``
(p_ref, ``subtract=True`` with ``i_pref = nq+2``) and, for a remainder,
``na=4`` with ``rem_lanes = (nq+3, nq+4, nq+5)``, with and without
``subtract``, and any face-lane range ``[sl_lo, sl_hi)`` within the
faces ("vertical": faces 4-5; "every": all).  Each wrapper counts its launches
in ``.launches``.  The plain versions cover the whole signature.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.weak import WeakIdKeyDictionary

from climatemachine_tpu_torch import cuda_build
from climatemachine_tpu_torch.dg import ldg_tables

MAX_LANES = 256       # one thread per face lane and per node, 256 at most


# --- plain versions (the JAX kernel bodies) ----------------------------------

def extract_trace_plain(qv, p, c_s, aux4, gl2k, nu, lift, nrm, *, nq: int,
                        na: int, ngl: int, has_hyper: bool):
    """qv ``[E, nq, Np]``, p/c_s ``[E, Np]``, aux4 ``[E, na, Np]``, gl2k
    ``[E, 3·ngl, Np]`` (∂ᵢ of chain variable j at lane ngl·i + j), nu
    ``[E, 2, Np]`` (ν₄, ν₄_q), lift ``[Np, X]``, nrm ``[E, 3, X]`` → face
    bundle ``[E, nvb, X]``, nvb = nq + 2 + na (+ nq with ``has_hyper``).
    aux4 is read only with ``na``; gl2k, nu and nrm only with
    ``has_hyper``."""
    if has_hyper and not (nq in (5, 6) and ngl >= nq - 1):
        raise ValueError(f"the n·F₂ trace lanes take nq=5 with ngl >= 4 or "
                         f"nq=6 with ngl >= 5, got nq={nq}, ngl={ngl}")
    E, _, Np = qv.shape
    X = lift.shape[1]

    def ext(a, n):
        return torch.matmul(a.reshape(E * n, Np), lift).reshape(E, n, X)

    qx = ext(qv, nq)
    parts = [qx, ext(p, 1), ext(c_s, 1)]
    if na:
        parts.append(ext(aux4, na))
    if has_hyper:
        g2 = ext(gl2k, 3 * ngl).reshape(E, 3, ngl, X)
        nux = ext(nu, 2)
        G = [nrm[:, 0] * g2[:, 0, j] + nrm[:, 1] * g2[:, 1, j]
             + nrm[:, 2] * g2[:, 2, j] for j in range(ngl)]
        rho = qx[:, 0]
        rnu = rho * nux[:, 0]
        s = [torch.zeros_like(rho)] + [rnu * G[j] for j in range(3)]
        s.append(nux[:, 0] * (qx[:, 1] * G[0] + qx[:, 2] * G[1]
                              + qx[:, 3] * G[2]) + rnu * G[3])
        if nq > 5:
            s.append(rho * nux[:, 1] * G[4])
        parts.append(torch.stack(s, dim=1))
    return torch.cat(parts, dim=1)


def surface_lift_plain(Bf, BP, nrm, sM, bmask, liftT, MI, *, nq: int,
                       nvb: int, subtract: bool, i_pref: int,
                       has_hyper: bool, rem_lanes: tuple, sl_lo: int,
                       sl_hi: int, R_d_T0: float, R_over_cv: float):
    """Bf/BP ``[E, nvb, X]`` (own and neighbour side), nrm ``[E, 3, X]``,
    sM/bmask ``[E, 1, X]`` (bmask 1.0 on wall lanes), liftT ``[X, Np]``,
    MI ``[E, Np]`` → −(MI · lift(sM · f*)) ``[E, nq, Np]``.  With
    ``rem_lanes = (φ, energy coefficient, sound speed)`` the linear
    acoustic(-gravity) Rusanov flux is taken out of f* on the face lanes
    ``[sl_lo, sl_hi)``."""
    E, _, X = Bf.shape
    Np = liftT.shape[1]
    n = [nrm[:, c] for c in range(3)]
    bm = bmask[:, 0]

    # wall ghost: reflect the normal momentum, copy everything else
    run = BP[:, 1] * n[0] + BP[:, 2] * n[1] + BP[:, 3] * n[2]
    ghost_mom = [BP[:, 1 + c] - 2.0 * run * n[c] for c in range(3)]
    P = [BP[:, v] for v in range(nvb)]
    for c in range(3):
        P[1 + c] = bm * ghost_mom[c] + (1.0 - bm) * P[1 + c]
    M = [Bf[:, v] for v in range(nvb)]

    def flux_n(S):
        rho = S[0]
        inv = 1.0 / rho
        un = (S[1] * n[0] + S[2] * n[1] + S[3] * n[2]) * inv
        pv = S[nq]
        p_eff = pv - S[i_pref] if subtract else pv
        Fn = [rho * un] + [S[1 + c] * un + p_eff * n[c] for c in range(3)]
        Fn.append((S[4] + pv) * un)
        Fn += [S[v] * un for v in range(5, nq)]
        return Fn, torch.abs(un) + S[nq + 1]

    FnM, cM = flux_n(M)
    FnP, cP = flux_n(P)
    c = torch.maximum(cM, cP)
    fstar = [0.5 * (FnM[v] + FnP[v]) - 0.5 * c * (P[v] - M[v])
             for v in range(nq)]

    if has_hyper:
        # +½(s⁻ − s⁺) on interior faces (wall faces carry no transport)
        base = nvb - nq
        for v in range(nq):
            d2 = 0.5 * (M[base + v] - P[base + v])
            fstar[v] = fstar[v] + (1.0 - bm) * d2

    if rem_lanes:
        i_lphi, i_lco, i_lcl = rem_lanes
        lane = torch.arange(X, device=Bf.device)
        m_lin = ((lane >= sl_lo) & (lane < sl_hi)).to(Bf.dtype)

        def flux_lin(S):
            rho, rhoe, phi = S[0], S[4], S[i_lphi]
            pL = rho * R_d_T0 + R_over_cv * (rhoe - rho * phi)
            un = S[1] * n[0] + S[2] * n[1] + S[3] * n[2]
            Fn = [un] + [pL * n[c] for c in range(3)] + [S[i_lco] * un]
            Fn += [torch.zeros_like(un)] * (nq - 5)
            return Fn, S[i_lcl]

        FnLM, cLM = flux_lin(M)
        FnLP, cLP = flux_lin(P)
        cl = torch.maximum(cLM, cLP)
        for v in range(nq):
            sub = 0.5 * (FnLM[v] + FnLP[v]) - 0.5 * cl * (P[v] - M[v])
            fstar[v] = fstar[v] - m_lin * sub

    smf = torch.stack([sM[:, 0] * f for f in fstar], dim=1)      # [E, nq, X]
    lifted = torch.matmul(smf.reshape(E * nq, X), liftT).reshape(E, nq, Np)
    return -(MI[:, None, :] * lifted)


# --- kernel wrappers ------------------------------------------------------------

_TABLES = WeakIdKeyDictionary()


def face_tables(matrix, transposed: bool):
    """The int32 tables ``(sel_idx [X], lift_idx [Np, L])`` of
    :func:`dg.ldg_tables.face_ops` for the 0/1 extraction matrix ``lift
    [Np, X]``, or for ``liftT [X, Np]`` with ``transposed``.  Built and
    checked (0/1, one 1 per face lane; anything else raises) once per
    matrix tensor, kept while it lives and rebuilt if it is written in
    place."""
    hit = _TABLES.get(matrix)
    if hit is None or hit[0] != matrix._version:
        lift = matrix.T if transposed else matrix
        fo = ldg_tables.face_ops(lift, lift.T)
        hit = _TABLES[matrix] = (matrix._version, fo.sel_idx, fo.lift_idx)
    return hit[1], hit[2]


@functools.cache
def _library():
    lib = cuda_build.load("surface_vm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    f32 = ctypes.c_float
    lib.extract_trace_vm_f32.argtypes = [ptr] * 9 + [i32] * 6 + [ptr]
    lib.surface_lift_vm_f32.argtypes = ([ptr] * 6 + [i32] + [ptr] * 2
                                        + [i32] * 9 + [f32] * 2 + [ptr])
    for fn in ("extract_trace_vm_f32", "surface_lift_vm_f32"):
        getattr(lib, fn).restype = ctypes.c_int
    lib.surface_vm_error_string.argtypes = [i32]
    lib.surface_vm_error_string.restype = ctypes.c_char_p
    return lib


def _check_tensors(name, ref, lanes, **tensors):
    """Refuse a tensor off CUDA, not float32, misshapen or not contiguous,
    and more than MAX_LANES face lanes or nodes."""
    if ref.device.type != "cuda":
        raise ValueError(f"the {name} kernel runs on CUDA tensors, got "
                         f"{ref.device}")
    for key, (t, shape) in tensors.items():
        if t.device != ref.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name} {key}: need a contiguous float32 {shape} tensor on "
                f"{ref.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if lanes > MAX_LANES:
        raise ValueError(f"the {name} kernel takes at most {MAX_LANES} face "
                         f"lanes and nodes, got {lanes}")


def _launch(name, fn, *args):
    lib = _library()
    ref = args[0]
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        code = getattr(lib, fn)(*[a.data_ptr() if isinstance(a, torch.Tensor)
                                  else a for a in args], stream)
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.surface_vm_error_string(code).decode())


def extract_trace_vm(qv, p, c_s, aux4, gl2k, nu, lift, nrm, *, nq: int,
                     na: int, ngl: int, has_hyper: bool):
    """Face bundle ``[E, nvb, X]`` of :func:`extract_trace_plain`'s
    arguments.  CPU tensors take the plain version; otherwise the CUDA
    kernel runs and ``extract_trace_vm.launches`` counts it."""
    if qv.device.type == "cpu":
        return extract_trace_plain(qv, p, c_s, aux4, gl2k, nu, lift, nrm,
                                   nq=nq, na=na, ngl=ngl, has_hyper=has_hyper)
    if nq not in (5, 6) or na not in (0, 1, 4) or (has_hyper
                                                    and ngl != nq - 1):
        raise NotImplementedError(
            "the CUDA extract_trace_vm kernel covers nq=5 or 6, the "
            "bundles' na=0, 1 or 4 and, with has_hyper, ngl=nq-1 (got "
            f"nq={nq}, na={na}, ngl={ngl}, has_hyper={has_hyper})")
    E, _, Np = qv.shape
    X = lift.shape[1]
    shapes = dict(qv=(qv, (E, nq, Np)), p=(p, (E, Np)), c_s=(c_s, (E, Np)),
                  lift=(lift, (Np, X)), nrm=(nrm, (E, 3, X)))
    if na:
        shapes["aux4"] = (aux4, (E, na, Np))
    if has_hyper:
        shapes.update(gl2k=(gl2k, (E, 3 * ngl, Np)), nu=(nu, (E, 2, Np)))
    _check_tensors("extract_trace_vm", qv, max(Np, X), **shapes)
    sel_idx, _ = face_tables(lift, transposed=False)
    out = torch.empty((E, nq + 2 + na + nq * has_hyper, X), dtype=qv.dtype,
                      device=qv.device)
    _launch("extract_trace_vm", "extract_trace_vm_f32", qv, p, c_s,
            aux4 if na else None, gl2k if has_hyper else None,
            nu if has_hyper else None, sel_idx, nrm, out, E, Np, X, nq, na,
            int(has_hyper))
    extract_trace_vm.launches += 1
    return out


def fused_surface_lift_vm(Bf, BP, nrm, sM, bmask, liftT, MI, *, nq: int,
                          nvb: int, subtract: bool, i_pref: int,
                          has_hyper: bool, rem_lanes: tuple, sl_lo: int,
                          sl_hi: int, R_d_T0: float, R_over_cv: float):
    """Surface tendency ``[E, nq, Np]`` of :func:`surface_lift_plain`'s
    arguments.  CPU tensors take the plain version; otherwise the CUDA
    kernel runs and ``fused_surface_lift_vm.launches`` counts it."""
    if Bf.device.type == "cpu":
        return surface_lift_plain(
            Bf, BP, nrm, sM, bmask, liftT, MI, nq=nq, nvb=nvb,
            subtract=subtract, i_pref=i_pref, has_hyper=has_hyper,
            rem_lanes=rem_lanes, sl_lo=sl_lo, sl_hi=sl_hi, R_d_T0=R_d_T0,
            R_over_cv=R_over_cv)
    rem_lanes = tuple(rem_lanes)
    # the bundles of dg/fast_rhs.py: p_ref (lane nq + 2) where it
    # subtracts, and a remainder's p_ref, φ, coefficient and sound speed
    na = 4 if rem_lanes else 1 if subtract else 0
    if nq not in (5, 6) or nvb != nq + 2 + na + nq * has_hyper \
            or (subtract and i_pref != nq + 2) or rem_lanes not in (
                (), (nq + 3, nq + 4, nq + 5)):
        raise NotImplementedError(
            "the CUDA fused_surface_lift_vm kernel covers nq=5 or 6, p_ref "
            "at i_pref=nq+2 with subtract=True, and the bundles nvb=nq+2 "
            "(subtract=False), nq+3 (subtract=True) or, with rem_lanes=("
            "nq+3, nq+4, nq+5), nq+6 (nq more with has_hyper) (got "
            f"nq={nq}, nvb={nvb}, subtract={subtract}, i_pref={i_pref}, "
            f"has_hyper={has_hyper}, rem_lanes={rem_lanes})")
    E, _, X = Bf.shape
    Np = liftT.shape[1]
    if rem_lanes and not 0 <= sl_lo <= sl_hi <= X:
        raise ValueError(f"fused_surface_lift_vm: the linear face lanes "
                         f"[{sl_lo}, {sl_hi}) are not within [0, {X})")
    _check_tensors("fused_surface_lift_vm", Bf, max(Np, X),
                   Bf=(Bf, (E, nvb, X)),
                   BP=(BP, (E, nvb, X)), nrm=(nrm, (E, 3, X)),
                   sM=(sM, (E, 1, X)), bmask=(bmask, (E, 1, X)),
                   liftT=(liftT, (X, Np)), MI=(MI, (E, Np)))
    _, lift_idx = face_tables(liftT, transposed=True)
    out = torch.empty((E, nq, Np), dtype=Bf.dtype, device=Bf.device)
    _launch("fused_surface_lift_vm", "surface_lift_vm_f32", Bf, BP, nrm, sM,
            bmask, lift_idx, lift_idx.shape[1], MI, out, E, Np, X, nq, na,
            int(has_hyper), int(subtract), sl_lo if rem_lanes else 0,
            sl_hi if rem_lanes else 0, R_d_T0, R_over_cv)
    fused_surface_lift_vm.launches += 1
    return out


extract_trace_vm.launches = 0
fused_surface_lift_vm.launches = 0

KERNELS = (extract_trace_vm, fused_surface_lift_vm)
PLAIN = (extract_trace_plain, surface_lift_plain)
