"""Dimensioned dataset writers (port of
``climatemachine_tpu/io/writers.py``: ``AbstractWriter``,
``NetCDFWriter``, ``NpzWriter``).

``NetCDFWriter`` writes the NetCDF-4 on-disk format, an HDF5 file with
dimension scales, through ``h5py``, which it imports at first use.
Without ``h5py`` (the GPU machine this port is measured on has none) it
raises ImportError: use ``NpzWriter`` there.  Neither writer falls back
to the other.  Both take numpy arrays: the diagnostics groups copy their
values to the host once per write.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np


class AbstractWriter:
    def init_data(self, path, dims, vars_):
        raise NotImplementedError

    def append_data(self, path, varvals, time):
        raise NotImplementedError


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("NetCDFWriter needs h5py, which this Python "
                          "lacks; pass NpzWriter() to the diagnostics "
                          "group instead") from e
    return h5py


class NetCDFWriter(AbstractWriter):
    """NetCDF-4 (HDF5 + dimension scales) writer.

    dims: {name: 1-D coordinate array}; vars: {name: (dim_names, dtype)}.
    An unlimited leading 'time' dimension is added to every variable.
    """

    def init_data(self, path: str,
                  dims: Dict[str, np.ndarray],
                  vars_: Dict[str, Tuple[Sequence[str], type]]) -> None:
        h5py = _h5py()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with h5py.File(path, "w") as f:
            tds = f.create_dataset("time", shape=(0,), maxshape=(None,),
                                   dtype="f8")
            tds.make_scale("time")
            for name, vals in dims.items():
                d = f.create_dataset(name, data=np.asarray(vals))
                d.make_scale(name)
            for name, (dnames, dtype) in vars_.items():
                shape = (0,) + tuple(len(dims[d]) for d in dnames)
                maxshape = (None,) + shape[1:]
                v = f.create_dataset(name, shape=shape, maxshape=maxshape,
                                     dtype=np.dtype(dtype).str)
                v.dims[0].attach_scale(f["time"])
                for i, d in enumerate(dnames):
                    v.dims[i + 1].attach_scale(f[d])

    def append_data(self, path: str, varvals: Dict[str, np.ndarray],
                    time: float) -> None:
        h5py = _h5py()
        with h5py.File(path, "a") as f:
            t = f["time"]
            n = t.shape[0]
            t.resize((n + 1,))
            t[n] = time
            for name, vals in varvals.items():
                v = f[name]
                v.resize((n + 1,) + v.shape[1:])
                v[n] = np.asarray(vals)


class NpzWriter(AbstractWriter):
    """npz time series: ``path`` holds the dimensions (``__dims__``, the
    names; ``dim_<name>``, the coordinates), and each append writes
    ``<path stem>_t<time>.npz`` with ``time`` and the variables."""

    def init_data(self, path, dims, vars_):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, __dims__=np.asarray(list(dims.keys()), dtype=str),
                 **{f"dim_{k}": np.asarray(v) for k, v in dims.items()})

    def append_data(self, path, varvals, time):
        base, ext = os.path.splitext(path)
        np.savez(f"{base}_t{time:.6e}{ext or '.npz'}",
                 time=time, **{k: np.asarray(v) for k, v in varvals.items()})
