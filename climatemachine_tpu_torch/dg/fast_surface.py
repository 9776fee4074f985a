"""Static face-neighbour tables and the neighbour gather of the var-major
surface passes (port of ``climatemachine_tpu/dg/fast_surface.py``
``_tables`` :99-132).

Face data is var-major ``[E, nvb, nface·Nfp]``.  The neighbour side of
face f is, for most elements, the opposite face ``f ^ 1`` of the
neighbour element: one row gather over elements of a contiguous lane
slice.  Panel-edge elements whose neighbour presents another face get
small row fix-ups.  Orientations must be identity (checked by the RHS).
"""

from __future__ import annotations

import numpy as np
import torch


def _tables(grid):
    """{"nbr_e": [E] per face, "fix": [(src_face, rows, src_elems)] per
    face, "opp": face ^ 1, "bnd_lane": [E, nface·Nfp] wall mask}, as
    int64/bool tensors on the grid's device."""
    nface, dev = grid.nface, grid.device
    nbr_row = grid.face_nbr_row.cpu().numpy()
    nbr_e, nbr_f = nbr_row // nface, nbr_row % nface
    opp = np.arange(nface) ^ 1
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
    tab = {"nbr_e": [], "fix": [], "opp": opp}
    for f in range(nface):
        tab["nbr_e"].append(idx(nbr_e[:, f]))
        fixes = []
        bad = nbr_f[:, f] != opp[f]
        for fsrc in np.unique(nbr_f[bad, f]):
            rows = np.where(bad & (nbr_f[:, f] == fsrc))[0]
            fixes.append((int(fsrc), idx(rows), idx(nbr_e[rows, f])))
        tab["fix"].append(fixes)
    bnd = grid.face_bctag.cpu().numpy() != 0
    tab["bnd_lane"] = torch.as_tensor(np.repeat(bnd, grid.Nfp_max, axis=1),
                                      device=dev)
    return tab


def gather_faces(tab, Bf, faces, Nfp: int):
    """Neighbour side of a minus-side face bundle ``[E, nvb, len(faces)·
    Nfp]`` that holds ``faces`` in that order.  The set must hold each
    face's opposite and its fix-up sources, as the faces of a direction
    do (at a wall the neighbour is the element's own face)."""
    pos = {f: i for i, f in enumerate(faces)}
    lanes = lambda f: slice(pos[f] * Nfp, (pos[f] + 1) * Nfp)
    blocks = []
    for f in faces:
        blk = Bf[:, :, lanes(int(tab["opp"][f]))][tab["nbr_e"][f]]
        for fsrc, rows, src_e in tab["fix"][f]:
            blk[rows] = Bf[src_e][:, :, lanes(fsrc)]
        blocks.append(blk)
    return torch.cat(blocks, dim=2)
