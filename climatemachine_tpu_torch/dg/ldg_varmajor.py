"""Var-major hyperdiffusion LDG chain, one pass at a time, and the
generic DG operator's entries to it (port of
``climatemachine_tpu/dg/ldg_varmajor.py`` grad_vm :169, div_vm :201,
hyper_chain :232, scalar_hyper_correction :259).

States ride var-major ``[E, n, Np]``, face traces ``[E, n, F]`` rows over
the active faces, and every structural operator (derivative, face
extraction, lift) is one matmul against a static matrix from
dg/ldg_tables.py.  grad_vm/div_vm are the plain chain: the tests and
chip_smoke.py hold the kernel chain (dg/ldg_kernel.py) against it, and
the generic DG operator runs it with ``ldg_kernel="varmajor"``.
"""

from __future__ import annotations

import torch

from climatemachine_tpu_torch.dg import ldg_kernel
from climatemachine_tpu_torch.dg.ldg_tables import W_for, exchange


def _Wcat_for(grid, tab, dims):
    """Fused ``[Np, nd·Np + F]`` operator: derivative and face
    extraction in one matmul."""
    return torch.cat([W_for(grid, dims).T, tab["fo"].Sel], dim=1)


def grad_vm(grid, xv, tab, geom, dims):
    """Var-major DG gradient: xv ``[E, n, Np] -> [E, 3, n, Np]``."""
    E, n, Np = xv.shape
    nd, F = len(dims), tab["F"]
    sM, nrm, xi, MI = geom
    cat = torch.matmul(xv.reshape(E * n, Np), _Wcat_for(grid, tab, dims))
    d = cat[:, :nd * Np].reshape(E, n, nd, Np)
    rowsM = cat[:, nd * Np:].reshape(E, n, F)
    dj = 0.5 * (exchange(rowsM, tab) - rowsM)
    w3 = sM * nrm                                          # [E, 3, F]
    prod = w3[:, :, None, :] * dj[:, None, :, :]           # [E, 3, n, F]
    corr = torch.matmul(prod.reshape(E * 3 * n, F),
                        tab["fo"].LT).reshape(E, 3, n, Np)
    out = []
    for c in range(3):
        vol = 0.0
        for ai in range(nd):
            vol = vol + xi[:, ai, c][:, None, :] * d[:, :, ai, :]
        out.append(vol + MI * corr[:, c])
    return torch.stack(out, dim=1)


def div_vm(grid, vv, tab, geom, dims):
    """Var-major DG divergence: vv ``[E, 3, n, Np] -> [E, n, Np]`` (only
    the n·v face scalars ride the exchange)."""
    E, _, n, Np = vv.shape
    nd, F = len(dims), tab["F"]
    sM, nrm, xi, MI = geom
    cat = torch.matmul(vv.reshape(E * 3 * n, Np), _Wcat_for(grid, tab, dims))
    dv = cat[:, :nd * Np].reshape(E, 3, n, nd, Np)
    div = 0.0
    for ai in range(nd):
        for c in range(3):
            div = div + xi[:, ai, c][:, None, :] * dv[:, c, :, ai, :]
    rows3 = cat[:, nd * Np:].reshape(E, 3, n, F)
    s = torch.sum(nrm[:, :, None, :] * rows3, dim=1)       # [E, n, F]
    dj = 0.5 * (tab["sign"][:, None, :] * exchange(s, tab) - s)
    corr = torch.matmul((sM * dj).reshape(E * n, F),
                        tab["fo"].LT).reshape(E, n, Np)
    return div + MI * corr


def hyper_chain(dg, q, aux, t, direction):
    """The hyper state of the generic DG operator ``dg`` at (q, aux): the
    balance law's gradient-Laplacian argument, its ∇Δ ``[E, 3, n, Np]``
    along ``direction``, then the balance law's transform.  With
    ``dg.ldg_kernel`` "auto" or "pallas" the chain runs through the four
    chain stages ``dg.chain_stages`` (the kernels by default), with
    "varmajor" through grad_vm/div_vm."""
    bl, g = dg.balance_law, dg.grid
    ops = dg.ldg_operators(direction)
    gl = bl.compute_gradient_laplacian_argument(q, aux, t)
    if dg.ldg_kernel == "varmajor":
        geom = dg.ldg_geometry(direction)
        grad = grad_vm(g, gl, ops.tab, geom, ops.dims)
        lap = div_vm(g, grad, ops.tab, geom, ops.dims)
        grad_lap = grad_vm(g, lap, ops.tab, geom, ops.dims)
    else:
        grad_lap = ldg_kernel.chain_vm(gl, ops, dg.chain_stages)
    return bl.transform_post_gradient_laplacian(grad_lap, q, aux, t)


def scalar_hyper_correction(dg, F2, direction):
    """The hyperdiffusive interface term of a hyper-only second-order
    flux F₂ ``[E, 3, nq, Np]`` on ``direction``'s faces: each side
    contracts its own volume F₂ with its own outward normal, s = n·F₂ (the
    neighbour's enters as −s⁺), and −M⁻¹ L (sM · ½(s − s⁺)) is taken on
    interior faces only (walls carry no hyperdiffusive transport).
    Returns the tendency ``[E, nq, Np]``."""
    ops = dg.ldg_operators(direction)
    tab, F = ops.tab, ops.tab["F"]
    E, _, nq, Np = F2.shape
    rows3 = torch.matmul(F2.reshape(E * 3 * nq, Np),
                         tab["fo"].Sel).reshape(E, 3, nq, F)
    s = torch.sum(ops.nrm[:, :, None, :] * rows3, dim=1)   # [E, nq, F]
    d2 = torch.where(ops.sign < 0, 0.5 * (s - exchange(s, tab)), 0.0)
    corr = torch.matmul((ops.sM[:, None, :] * d2).reshape(E * nq, F),
                        tab["fo"].LT).reshape(E, nq, Np)
    return -(ops.MI[:, None, :] * corr)
