"""Var-major hyperdiffusion LDG chain, one pass at a time (port of
``climatemachine_tpu/dg/ldg_varmajor.py`` grad_vm :169, div_vm :201).

States ride var-major ``[E, n, Np]``, face traces ``[E, n, F]`` rows over
the active faces, and every structural operator (derivative, face
extraction, lift) is one matmul against a static matrix from
dg/ldg_tables.py.  This is the plain chain: the tests and chip_smoke.py
hold the kernel chain (dg/ldg_kernel.py) against it.
"""

from __future__ import annotations

import torch

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
