"""Checkpoints and restarts (port of
``climatemachine_tpu/driver/checkpoint.py`` :30-130: ``checkpoint_path``,
``write_checkpoint``, ``read_checkpoint``, ``rm_checkpoint``).

One ``.npz`` a checkpoint, named ``<name>_checkpoint_rank0000_num<NNNN>.npz``
as the JAX package names its rank files (the port runs one process), with
the keys ``q``, ``aux``, ``t`` and ``step``.  q and aux are stored in the
packages' public node-major layout ``[E, Np, n]`` (interop.py), in the
state's dtype, so that a file either package writes restarts the other;
the port's var-major ``[E, n, Np]`` state is transposed on the way out
(``write_checkpoint``) and back in (``restart_from`` in
driver/solver_configs.py).  The JAX package's sharded files (``q__shard…``
keys, one rank file each) are refused: the port refuses a sharded model.
"""

from __future__ import annotations

import os

import numpy as np

from climatemachine_tpu_torch.interop import state_to_numpy


def checkpoint_path(directory: str, name: str, num: int) -> str:
    """The file of checkpoint ``num`` of run ``name`` in ``directory``."""
    return os.path.join(directory,
                        f"{name}_checkpoint_rank0000_num{num:04d}.npz")


def write_checkpoint(directory: str, name: str, num: int, q, aux, t: float,
                     step: int) -> str:
    """Copy var-major q and aux to the host and save them node-major with
    t and step; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, name, num)
    qn, auxn = state_to_numpy(q, aux)
    np.savez(path, q=qn, aux=auxn, t=float(t), step=int(step))
    return path


def read_checkpoint(directory: str, name: str, num: int):
    """(q, aux, t, step) of a checkpoint: q and aux node-major numpy arrays
    ``[E, Np, n]`` in the file's dtype."""
    path = checkpoint_path(directory, name, num)
    with np.load(path) as f:
        if "q" not in f.files:
            raise NotImplementedError(
                f"next slice: a sharded checkpoint ({path} holds "
                f"{sorted(f.files)})")
        return f["q"], f["aux"], float(f["t"]), int(f["step"])


def rm_checkpoint(directory: str, name: str, num: int) -> None:
    """Remove checkpoint ``num`` of run ``name`` where it exists."""
    try:
        os.remove(checkpoint_path(directory, name, num))
    except FileNotFoundError:
        pass
