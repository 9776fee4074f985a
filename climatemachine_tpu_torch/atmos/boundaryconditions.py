"""Atmosphere boundary-condition tags (port of
``climatemachine_tpu/atmos/boundaryconditions.py``).

The var-major RHS implements one wall: impenetrable free slip for
momentum (reflect the normal component), insulating for energy and
impermeable for moisture.  These classes only name that choice;
dg/fast_rhs.py checks for them and builds the ghost state itself.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class FreeSlip:
    pass


@dataclass(frozen=True)
class Impenetrable:
    bc: object = field(default_factory=FreeSlip)


class Insulating:
    pass


class Impermeable:
    pass


@dataclass(frozen=True)
class AtmosBC:
    momentum: object = field(default_factory=lambda: Impenetrable(FreeSlip()))
    energy: object = field(default_factory=Insulating)
    moisture: object = field(default_factory=Impermeable)

    def is_free_slip_wall(self) -> bool:
        mom = self.momentum
        if isinstance(mom, Impenetrable):
            mom = mom.bc
        return (type(mom) is FreeSlip and type(self.energy) is Insulating
                and type(self.moisture) is Impermeable)
