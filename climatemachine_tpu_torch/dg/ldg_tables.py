"""Static tables and the face exchange of the var-major hyperdiffusion
LDG chain, shared by the per-pass chain (dg/ldg_varmajor.py) and the
kernel chain (dg/ldg_kernel.py) (port of
``climatemachine_tpu/dg/ldg_varmajor.py``: _tables :53, _geom :114,
_W_for :140, _exchange :157 with _rows_to_R2/_R2_to_rows :129).

Face traces ride ``[E, n, F]`` rows over the active faces (F = nfa·Nfp).
The neighbour map is in active-face row space: row (e, j) of face
``faces[j]`` reads row ``nbr_active[e·nfa + j] = ne·nfa + pos[nf]`` of
its neighbour, which handles panel edges (where the neighbour presents
another face) without fix-ups.  Single device, identity face
orientations and uniform Nfp only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class FaceOps:
    """The face selection ``Sel [Np, F]`` and lift ``LT [F, Np]`` (0/1),
    dense for the plain chains and as index tables for the kernels:
    ``sel_idx [F]`` the volume node of each face column, ``lift_idx
    [Np, L]`` the face columns landing on each node (ascending, −1
    padded), both int32."""
    Sel: torch.Tensor
    LT: torch.Tensor
    sel_idx: torch.Tensor
    lift_idx: torch.Tensor

    @property
    def F(self) -> int:
        return self.Sel.shape[1]


def face_ops(Sel, LT) -> FaceOps:
    """:class:`FaceOps` from 0/1 matrices with one 1 in each face column
    (``Sel``'s columns, ``LT``'s rows); anything else raises."""
    S, L = Sel.cpu().numpy(), LT.cpu().numpy()
    for name, a in (("Sel", S), ("LT^T", L.T)):
        if not (np.isin(a, (0.0, 1.0)).all() and (a.sum(0) == 1).all()):
            raise ValueError(f"{name} must be 0/1 with one 1 per face column")
    sel_idx = S.argmax(0)
    per_node = [np.flatnonzero(L[:, m]) for m in range(L.shape[1])]
    width = max(1, max(len(c) for c in per_node))
    lift_idx = -np.ones((L.shape[1], width), dtype=np.int32)
    for m, cols in enumerate(per_node):
        lift_idx[m, :len(cols)] = cols
    idx = lambda a: torch.as_tensor(a, dtype=torch.int32, device=Sel.device)
    return FaceOps(Sel=Sel, LT=LT, sel_idx=idx(sel_idx),
                   lift_idx=idx(lift_idx))


def tables(grid, faces):
    """Static tables for the active ``faces``, built in host numpy and
    uploaded once: ``fo`` (:class:`FaceOps`), ``nbr_active [E·nfa]``,
    ``sign [E, F]`` (+1 on wall faces, −1 inside), ``F``, ``nfa`` and
    ``Nfp``."""
    Np, Nfp, nface, E = grid.Np, grid.Nfp_max, grid.nface, grid.nelem
    if len(set(grid.Nfp)) != 1:
        raise ValueError("the var-major chain needs a uniform Nfp")
    nfa = len(faces)
    F = nfa * Nfp
    fmask = grid.fmask_padded
    SelT = np.zeros((Np, F))
    for j, f in enumerate(faces):
        SelT[fmask[f], j * Nfp + np.arange(Nfp)] = 1.0
    lift = grid.lift.cpu().numpy()
    cols = np.concatenate([np.arange(f * Nfp, (f + 1) * Nfp) for f in faces])
    LT = lift[:, cols].T

    nbr_row = grid.face_nbr_row.cpu().numpy().reshape(E, nface)
    pos = -np.ones(nface, dtype=np.int64)
    pos[list(faces)] = np.arange(nfa)
    ne = nbr_row[:, list(faces)] // nface
    nf = nbr_row[:, list(faces)] % nface
    if (pos[nf] < 0).any():
        raise ValueError("an active face has a neighbour across an "
                         "inactive face")
    nbr_active = (ne * nfa + pos[nf]).reshape(-1)

    bctag = grid.face_bctag.cpu().numpy()[:, list(faces)]
    sign = np.repeat(np.where(bctag != 0, 1.0, -1.0), Nfp, axis=1)
    dev = lambda a: torch.as_tensor(a, dtype=grid.dtype, device=grid.device)
    return dict(fo=face_ops(dev(SelT), dev(LT)),
                nbr_active=torch.as_tensor(nbr_active, device=grid.device),
                sign=dev(sign), F=F, nfa=nfa, Nfp=Nfp, _gather={})


def geom(grid, faces, dims):
    """Var-major geometry: sM ``[E, 1, F]``, normals ``[E, 3, F]``,
    ξ ``[E, nd, 3, Np]`` (∂ξ_dims[ai]/∂x_c at [ai, c]), MI ``[E, 1, Np]``."""
    E = grid.nelem
    fl = list(faces)
    sM = grid.sM[:, fl, :].reshape(E, 1, -1)
    nrm = grid.normals[:, fl].permute(0, 3, 1, 2).reshape(E, 3, -1)
    xi = grid.xi_x[:, :, list(dims), :].permute(0, 2, 3, 1)
    return sM.contiguous(), nrm.contiguous(), xi.contiguous(), \
        grid.MI[:, None, :]


def W_for(grid, dims):
    """Stacked derivative operator ``[nd·Np, Np]`` for ``dims``."""
    if len(dims) == grid.dim:
        return grid.Wgrad
    Np = grid.Np
    return torch.cat([grid.Wgrad[a * Np:(a + 1) * Np] for a in dims], dim=0)


def exchange(rows, tab):
    """Neighbour face values ``[E, n, F] -> [E, n, F]``: one gather of
    ``Nfp``-long rows, where the JAX package transposes to
    ``[E·nfa, n·Nfp]``, gathers and transposes back.  Row (e, v, j)
    reads row (ne, v, jn) with ne·nfa + jn = nbr_active[e·nfa + j]; the
    flat row ids are built once per n."""
    E, n, F = rows.shape
    nfa, Nfp = tab["nfa"], tab["Nfp"]
    idx = tab["_gather"].get(n)
    if idx is None:
        nbr = tab["nbr_active"].reshape(E, 1, nfa)
        ne, jn = nbr // nfa, nbr % nfa
        v = torch.arange(n, device=nbr.device).reshape(1, n, 1)
        idx = tab["_gather"][n] = ((ne * n + v) * nfa + jn).reshape(-1)
    return torch.index_select(rows.reshape(E * n * nfa, Nfp), 0,
                              idx).reshape(E, n, F)
