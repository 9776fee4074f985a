"""Named, statically sized views over var-major state.

Port of ``climatemachine_tpu/utils/variables.py`` (``VarSpec``).  The
schema maps dotted names to slots of the variable axis, in the same
order as the JAX package, so the two packages' state and aux lanes line
up one to one.  The port keeps state var-major ``[E, nvar, Np]``, so
:meth:`VarSpec.get` reads axis 1.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple


def _normshape(shape) -> Tuple[int, ...]:
    if isinstance(shape, int):
        return () if shape == 1 else (shape,)
    return tuple(shape)


class VarSpec:
    """``VarSpec(rho=1, rhou=3, energy=VarSpec(rhoe=1))`` gives slots
    ``rho``, ``rhou[0..2]``, ``energy.rhoe`` packed contiguously."""

    def __init__(self, **fields):
        self._fields: dict = {}
        off = 0
        for name, spec in fields.items():
            if isinstance(spec, VarSpec):
                self._fields[name] = ("sub", spec._with_base(off))
                off += spec.num
            else:
                shape = _normshape(spec)
                self._fields[name] = ("leaf", off, shape)
                off += int(math.prod(shape)) if shape else 1
        self._num = off
        self._base = 0

    def _with_base(self, base: int) -> "VarSpec":
        out = VarSpec.__new__(VarSpec)
        out._fields = {}
        for name, ent in self._fields.items():
            if ent[0] == "leaf":
                out._fields[name] = ("leaf", ent[1] + base, ent[2])
            else:
                out._fields[name] = ("sub", ent[1]._with_base(base))
        out._num = self._num
        out._base = self._base + base
        return out

    @property
    def num(self) -> int:
        return self._num

    def _resolve(self, name: str):
        spec = self
        parts = name.split(".")
        for p in parts[:-1]:
            kind, sub = spec._fields[p][0], spec._fields[p][1]
            if kind != "sub":
                raise KeyError(f"{p} is a leaf, cannot descend into it")
            spec = sub
        ent = spec._fields[parts[-1]]
        if ent[0] == "leaf":
            return ent[1], ent[2]
        return ent[1]._base, (ent[1].num,)

    def index(self, name: str) -> slice:
        """Slots of dotted ``name`` on the variable axis."""
        off, shape = self._resolve(name)
        return slice(off, off + (int(math.prod(shape)) if shape else 1))

    def names(self) -> Sequence[str]:
        """The top-level field names, in packed order."""
        return list(self._fields)

    def flattened_names(self, prefix: str = "") -> Sequence[str]:
        """Dotted names of all scalar slots, in packed order."""
        out = []
        for name, ent in self._fields.items():
            full = f"{prefix}{name}"
            if ent[0] == "sub":
                out.extend(ent[1].flattened_names(prefix=full + "."))
                continue
            n = int(math.prod(ent[2])) if ent[2] else 1
            out.extend([full] if n == 1
                       else [f"{full}[{i}]" for i in range(n)])
        return out

    def field_dict(self) -> dict:
        """{name: shape or VarSpec}, to rebuild or compose specs."""
        out = {}
        for name, ent in self._fields.items():
            if ent[0] == "sub":
                out[name] = VarSpec(**ent[1].field_dict())
            else:
                out[name] = ent[2] if ent[2] else 1
        return out

    def pack(self, values: dict):
        """A var-major ``[E, num, L]`` tensor with ``values`` (name → ``[E,
        L]`` scalar or ``[E, n, L]`` vector) in their slots and 0
        elsewhere, in the dtype and on the device of the first value."""
        first = next(iter(values.values()))
        out = first.new_zeros((first.shape[0], self.num, first.shape[-1]))
        for name, val in values.items():
            sl = self.index(name)
            out[:, sl] = val.reshape(out[:, sl].shape)
        return out

    def get(self, arr, name: str):
        """Var-major view ``arr[:, slots, :]``; scalars drop the var axis
        (``[E, Np]``), vectors keep it (``[E, n, Np]``)."""
        off, shape = self._resolve(name)
        if not shape:
            return arr[:, off]
        return arr[:, off:off + int(math.prod(shape))]

    def __repr__(self):
        return f"VarSpec({', '.join(self.flattened_names())})"
