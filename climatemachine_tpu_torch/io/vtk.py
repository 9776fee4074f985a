"""VTK output, VTU and PVTU, dependency-free (port of
``climatemachine_tpu/io/vtk.py``: ``writevtk``, ``writepvtu``,
``vtk_dump_state``), and :func:`readvtk`, which parses a file
:func:`writevtk` wrote.

Each DG element is split into (Nq1-1)(Nq2-1)(Nq3-1) linear hexahedral
(or quad) sub-cells over its LGL nodes; fields are point data in ascii.
The state is var-major ``[E, n, Np]``: each lane is one field.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, Sequence

import numpy as np


def _write_rows(f, arr, fmt: str, block: int = 1 << 16):
    """The text ``np.savetxt(f, arr, fmt)`` writes for a 2-D ``arr``, one
    format call per block of rows (savetxt formats row by row: about
    three times slower at a million rows)."""
    row = " ".join([fmt] * arr.shape[1]) + "\n"
    for s in range(0, arr.shape[0], block):
        b = arr[s:s + block]
        f.write((row * b.shape[0]) % tuple(b.ravel().tolist()))


def _cells_for_element(Nq, dim):
    """Connectivity offsets (into the element's Np nodes) of sub-cells."""
    if dim == 3:
        Nq1, Nq2, Nq3 = Nq
        idx = np.arange(Nq1 * Nq2 * Nq3).reshape(Nq3, Nq2, Nq1)
        cells = []
        for k in range(Nq3 - 1):
            for j in range(Nq2 - 1):
                for i in range(Nq1 - 1):
                    cells.append([idx[k, j, i], idx[k, j, i + 1],
                                  idx[k, j + 1, i + 1], idx[k, j + 1, i],
                                  idx[k + 1, j, i], idx[k + 1, j, i + 1],
                                  idx[k + 1, j + 1, i + 1],
                                  idx[k + 1, j + 1, i]])
        return np.asarray(cells), 12  # VTK_HEXAHEDRON
    Nq1, Nq2 = Nq
    idx = np.arange(Nq1 * Nq2).reshape(Nq2, Nq1)
    cells = []
    for j in range(Nq2 - 1):
        for i in range(Nq1 - 1):
            cells.append([idx[j, i], idx[j, i + 1], idx[j + 1, i + 1],
                          idx[j + 1, i]])
    return np.asarray(cells), 9      # VTK_QUAD


def writevtk(prefix: str, grid, fields: Dict[str, np.ndarray]) -> str:
    """Write ``<prefix>.vtu`` with per-node ``fields`` {name: [E, Np]}
    (numpy); returns its path."""
    coords = grid.coords.detach().cpu().double().numpy()
    E, Np, ncoord = coords.shape
    cell_off, ctype = _cells_for_element(grid.Nq, grid.dim)

    pts = coords.reshape(E * Np, ncoord)
    if ncoord == 2:
        pts = np.concatenate([pts, np.zeros((E * Np, 1))], axis=1)

    conn = (cell_off[None, :, :] + (np.arange(E) * Np)[:, None, None])
    conn = conn.reshape(-1, cell_off.shape[1])
    ncells = conn.shape[0]
    offsets = np.arange(1, ncells + 1) * cell_off.shape[1]

    path = prefix + ".vtu"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n')
        f.write('  <UnstructuredGrid>\n')
        f.write(f'    <Piece NumberOfPoints="{E * Np}" '
                f'NumberOfCells="{ncells}">\n')
        f.write('      <Points>\n')
        f.write('        <DataArray type="Float64" '
                'NumberOfComponents="3" format="ascii">\n')
        _write_rows(f, pts, "%.10g")
        f.write('        </DataArray>\n      </Points>\n')
        f.write('      <Cells>\n')
        f.write('        <DataArray type="Int64" Name="connectivity" '
                'format="ascii">\n')
        _write_rows(f, conn, "%d")
        f.write('        </DataArray>\n')
        f.write('        <DataArray type="Int64" Name="offsets" '
                'format="ascii">\n')
        _write_rows(f, offsets[None, :], "%d")
        f.write('        </DataArray>\n')
        f.write('        <DataArray type="UInt8" Name="types" '
                'format="ascii">\n')
        _write_rows(f, np.full((1, ncells), ctype), "%d")
        f.write('        </DataArray>\n      </Cells>\n')
        f.write('      <PointData>\n')
        for name, arr in fields.items():
            a = np.asarray(arr, dtype=np.float64).reshape(E * Np)
            f.write(f'        <DataArray type="Float64" Name="{name}" '
                    'format="ascii">\n')
            _write_rows(f, a[None, :], "%.10g")
            f.write('        </DataArray>\n')
        f.write('      </PointData>\n')
        f.write('    </Piece>\n  </UnstructuredGrid>\n</VTKFile>\n')
    return path


def writepvtu(prefix: str, piece_prefixes: Sequence[str],
              field_names: Sequence[str]) -> str:
    """The master file of per-process pieces; returns its path."""
    path = prefix + ".pvtu"
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="PUnstructuredGrid" version="0.1">\n')
        f.write('  <PUnstructuredGrid GhostLevel="0">\n')
        f.write('    <PPoints>\n      <PDataArray type="Float64" '
                'NumberOfComponents="3"/>\n    </PPoints>\n')
        f.write('    <PPointData>\n')
        for name in field_names:
            f.write(f'      <PDataArray type="Float64" Name="{name}"/>\n')
        f.write('    </PPointData>\n')
        for p in piece_prefixes:
            f.write(f'    <Piece Source="{os.path.basename(p)}.vtu"/>\n')
        f.write('  </PUnstructuredGrid>\n</VTKFile>\n')
    return path


def vtk_dump_state(prefix: str, dg, q) -> str:
    """Write every lane of var-major ``q``, named by the balance law's
    prognostic schema, as a field of ``<prefix>.vtu`` (the JAX package
    writes no aux either); the state is copied to the host once."""
    spec = dg.balance_law.prog_spec
    qn = q.detach().cpu().numpy()
    fields = {name.replace(".", "_").replace("[", "_").rstrip("]"):
              qn[:, i] for i, name in enumerate(spec.flattened_names())}
    return writevtk(prefix, dg.grid, fields)


def readvtk(path: str) -> Dict[str, np.ndarray]:
    """The arrays of a ``.vtu`` file :func:`writevtk` wrote: ``points``
    ``[n, 3]``, ``connectivity`` ``[ncells, nverts]``, ``offsets``,
    ``types`` and each point-data field ``[n]`` by name.  Raises
    ValueError where a count disagrees with the piece's header."""
    piece = ET.parse(path).getroot().find("UnstructuredGrid/Piece")
    npts, ncells = (int(piece.get(k)) for k in ("NumberOfPoints",
                                                 "NumberOfCells"))
    read = lambda el, dtype: np.array(el.text.split(), dtype=dtype)
    out = {"points": read(piece.find("Points/DataArray"),
                          np.float64).reshape(npts, 3)}
    for el in piece.find("Cells"):
        out[el.get("Name")] = read(el, np.int64)
    out["connectivity"] = out["connectivity"].reshape(ncells, -1)
    for el in piece.find("PointData"):
        out[el.get("Name")] = read(el, np.float64)
    sizes = {"offsets": ncells, "types": ncells}
    sizes.update({el.get("Name"): npts for el in piece.find("PointData")})
    for name, n in sizes.items():
        if out[name].shape != (n,):
            raise ValueError(f"{path}: {name} has {out[name].shape[0]} "
                             f"values, the header says {n}")
    return out
