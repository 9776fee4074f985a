"""The forced LES cases in one table (read by ``chip_smoke.py`` and
``profile_step.py --forcing``): each case's configuration builder with
the options that set it apart, its Courant number, its solver type and
the ``invoke`` callbacks of a configuration, as its experiment module's
``main`` uses them."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from climatemachine_tpu_torch.experiments import (bomex_les,
                                                  boundary_layer_les,
                                                  canopy_sgstke, dycoms)


@dataclass(frozen=True)
class ForcedLESCase:
    builder: Callable
    courant: float
    solver_type: Optional[object] = None
    options: dict = field(default_factory=dict)
    callbacks: Callable = lambda dc: ()

    def config(self, *args, device=None):
        """The case's ``AtmosLESConfiguration``: ``args`` are the
        builder's leading positional ones (the resolution, then the
        domain where it takes one), its example's defaults if empty."""
        return self.builder(*args, **self.options, device=device)


CASES = {
    "bomex": ForcedLESCase(
        bomex_les.bomex_config, bomex_les.COURANT,
        callbacks=lambda dc: (bomex_les.tmar_callback(dc),)),
    "dycoms": ForcedLESCase(dycoms.dycoms_config, dycoms.COURANT),
    "convective_bl": ForcedLESCase(boundary_layer_les.convective_bl_config,
                                   boundary_layer_les.COURANT),
    "stable_bl": ForcedLESCase(boundary_layer_les.stable_bl_config,
                               boundary_layer_les.COURANT),
    "stable_bl_custom_sbl": ForcedLESCase(
        boundary_layer_les.stable_bl_config, boundary_layer_les.COURANT,
        options={"surface_flux": "custom_sbl"}),
    "canopy": ForcedLESCase(canopy_sgstke.canopy_config,
                            canopy_sgstke.COURANT, canopy_sgstke.SOLVER_TYPE),
}
