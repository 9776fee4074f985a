"""Diagnostics configuration for the driver (port of
``climatemachine_tpu/driver/diagnostics_configs.py``:
``DiagnosticsConfiguration``, ``InterpolationConfiguration``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from climatemachine_tpu_torch.mesh import interpolation as interp


@dataclass
class DiagnosticsConfiguration:
    """Diagnostics groups (and ``StateCheck`` objects) fired every
    ``every_steps`` steps: ``invoke(sc, diagnostics_config=...)``
    appends their callbacks to the run's."""
    groups: Sequence = ()
    every_steps: int = 100

    def make_callbacks(self, solver_config, dt):
        return [g.make_callback(self.every_steps) for g in self.groups]


def InterpolationConfiguration(driver_config, resolution=None):
    """An interpolator matching the configuration's grid: a cubed sphere
    (a GCM configuration, whose ``config_info`` has ``domain_height``)
    → (lat, lon, level) at ``resolution`` = (nlat, nlon, nlev), by
    default (91, 180, 4 n_vert) with the levels at the middles of nlev
    equal layers; a brick → a regular x-y-z grid over its extent, (16,
    16, 16) points by default."""
    grid = driver_config.grid
    info = driver_config.config_info
    if "domain_height" in info:
        nlat, nlon, nlev = resolution or (91, 180, info.get("n_vert", 4) * 4)
        a = driver_config.model.param_set.planet_radius
        H = info["domain_height"]
        lats = np.linspace(-89.5, 89.5, nlat)
        lons = np.linspace(-180.0, 179.0, nlon)
        rads = a + np.linspace(0.0, H, nlev + 1)[:-1] + H / (2 * nlev)
        return interp.InterpolationCubedSphere(grid, lats, lons, rads)
    coords = grid.coords.detach().cpu().double().numpy().reshape(
        -1, grid.coords.shape[-1])
    mins, maxs = coords.min(axis=0), coords.max(axis=0)
    resolution = resolution or (16, 16, 16)
    axes = [np.linspace(mins[d], maxs[d], resolution[d]) for d in range(3)]
    return interp.InterpolationBrick(grid, *axes)
