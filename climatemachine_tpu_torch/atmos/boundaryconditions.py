"""Atmosphere boundary-condition tags (port of
``climatemachine_tpu/atmos/boundaryconditions.py``).

One wall is implemented: impenetrable free slip for momentum (reflect
the normal component), insulating for energy and impermeable for
moisture.  The var-major RHS (dg/fast_rhs.py) checks for it and builds
the ghost state in its surface pass; the generic DG operator
(dg/spatial.py) asks :meth:`AtmosBC.ghost_state` for it (port of
``AtmosBC.ghost_state`` :146 with ``FreeSlip.ghost_rhou`` :34 and the
copying ``EnergyBC.ghost_rhoe`` :68).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


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

    def ghost_state(self, model, nrm, q, aux, t):
        """(q_ghost, aux) on var-major face lanes: q ``[E, n, X]``,
        normals ``[E, 3, X]``; ρu loses twice its normal component, the
        rest is copied: ρe (insulating), ρq_tot (impermeable) and the
        precipitation and tracer lanes, which the JAX ghost leaves as
        they are too."""
        if not self.is_free_slip_wall():
            raise NotImplementedError(f"next slice: wall {self!r}")
        sl = model.prog_spec.index("rhou")
        rhou = q[:, sl]
        un = torch.sum(rhou * nrm, dim=1, keepdim=True)
        qg = q.clone()
        qg[:, sl] = rhou - 2 * un * nrm
        return qg, aux
