"""Driver configurations (port of ``climatemachine_tpu/driver/configs.py``
:30-121: ``DriverConfiguration``, ``grid_stretching_1d``,
``AtmosLESConfiguration``, ``AtmosGCMConfiguration`` and
``SingleStackConfiguration``).

``AtmosLESConfiguration`` builds the LES box: a stacked brick (lateral
sides periodic, the bottom wall tag 1, the top tag 2) whose elements are
``polyorder`` nodes of the resolution Δ across, and its grid;
``AtmosGCMConfiguration`` the stacked cubed sphere of (n_horz, n_vert)
elements from the planet's radius up to ``domain_height``;
``SingleStackConfiguration`` one column of ``nelem_vert`` elements.  All
put the grid on the card unless ``device`` (or the driver's ``disable_gpu``
setting) asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from climatemachine_tpu_torch.dg.numerical_fluxes import (
    CentralNumericalFluxGradient, CentralNumericalFluxSecondOrder,
    RusanovNumericalFlux)
from climatemachine_tpu_torch.driver.driver import SETTINGS
from climatemachine_tpu_torch.mesh.grid import Grid, make_grid
from climatemachine_tpu_torch.mesh.topology import (
    equiangular_cubed_sphere_warp, stacked_brick_topology,
    single_stack_topology, stacked_cubed_sphere_topology)

#: the cubed sphere's warps by name
_WARPS = {"equiangular": equiangular_cubed_sphere_warp}


@dataclass
class DriverConfiguration:
    name: str
    polyorder: int
    grid: Grid
    model: object
    numerical_flux_first_order: object = field(
        default_factory=RusanovNumericalFlux)
    numerical_flux_gradient: object = field(
        default_factory=CentralNumericalFluxGradient)
    numerical_flux_second_order: object = field(
        default_factory=CentralNumericalFluxSecondOrder)
    config_info: dict = field(default_factory=dict)


def grid_stretching_1d(x0: float, x1: float, n: int,
                       stretch: Optional[float] = None) -> np.ndarray:
    """n + 1 element interfaces on [x0, x1], exponentially stretched
    toward x0 by ``stretch`` (uniform without)."""
    s = np.linspace(0.0, 1.0, n + 1)
    if stretch:
        s = (np.exp(stretch * s) - 1) / (np.exp(stretch) - 1)
    return x0 + (x1 - x0) * s


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (None: float32)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def default_device():
    """The CPU where the driver's ``disable_gpu`` asks for it, else None
    (the card)."""
    if SETTINGS.disable_gpu:
        return "cpu"
    return None


def AtmosLESConfiguration(name: str, polyorder: int, resolution: Tuple,
                          xmax: float, ymax: float, zmax: float, model,
                          periodicity=(True, True, False),
                          boundary=((0, 0), (0, 0), (1, 2)),
                          dtype=None, device=None) -> DriverConfiguration:
    """The LES box [0, xmax] × [0, ymax] × [0, zmax] at resolution (Δx,
    Δy, Δz): round(L / (Δ N)) elements along each side (at least one),
    on a stacked brick with ``periodicity`` and ``boundary`` tags, its
    grid of order ``polyorder`` in ``dtype`` (torch or numpy; float32 by
    default) on ``device`` (:func:`default_device` by default)."""
    if not isinstance(polyorder, int):
        raise NotImplementedError("next slice: separate horizontal and "
                                  "vertical polynomial orders")
    N = max(polyorder, 1)
    nel = [max(int(round(L / (d * N))), 1)
           for L, d in zip((xmax, ymax, zmax), resolution)]
    ranges = [np.linspace(0.0, L, n + 1)
              for L, n in zip((xmax, ymax, zmax), nel)]
    topology = stacked_brick_topology(ranges, periodicity=periodicity,
                                      boundary=np.asarray(boundary))
    grid = make_grid(topology, polyorder, dtype=_torch_dtype(dtype),
                     device=device if device is not None
                     else default_device())
    return DriverConfiguration(name, polyorder, grid, model,
                               config_info=dict(resolution=resolution))


def AtmosGCMConfiguration(name: str, polyorder: int,
                          resolution: Tuple[int, int], domain_height: float,
                          model, planet_radius: Optional[float] = None,
                          dtype=None, meshwarp=None, device=None
                          ) -> DriverConfiguration:
    """The GCM shell: a stacked cubed sphere of ``resolution`` = (n_horz,
    n_vert) elements, its layers evenly spaced from the planet's radius
    (``planet_radius``, else the model's parameter set's) up to
    ``domain_height`` above it, its grid of order ``polyorder`` in
    ``dtype`` on ``device`` as :func:`AtmosLESConfiguration` takes
    them.  ``meshwarp`` is a warp name ("equiangular", the default) or a
    callable (x1, x2, x3) → (x1, x2, x3) of the nodal coordinates in its
    place."""
    n_horz, n_vert = resolution
    a = planet_radius if planet_radius is not None \
        else model.param_set.planet_radius
    vert_range = a + np.linspace(0.0, domain_height, n_vert + 1)
    topology = stacked_cubed_sphere_topology(n_horz, vert_range)
    if meshwarp is not None:
        topology = dataclasses.replace(topology, meshwarp=(
            _WARPS[meshwarp] if isinstance(meshwarp, str) else meshwarp))
    grid = make_grid(topology, polyorder, dtype=_torch_dtype(dtype),
                     device=device if device is not None
                     else default_device())
    return DriverConfiguration(name, polyorder, grid, model,
                               config_info=dict(n_horz=n_horz, n_vert=n_vert,
                                                domain_height=domain_height))


def SingleStackConfiguration(name: str, polyorder: int, nelem_vert: int,
                             zmax: float, model, hmax: float = 1.0,
                             dtype=None, device=None) -> DriverConfiguration:
    """One column: a single hmax × hmax element, periodic laterally, over
    ``nelem_vert`` even layers from 0 to ``zmax`` (bottom wall tag 1, top
    tag 2), its grid of order ``polyorder`` in ``dtype`` on ``device`` as
    :func:`AtmosLESConfiguration` takes them."""
    topology = single_stack_topology(hmax, hmax,
                                     np.linspace(0.0, zmax, nelem_vert + 1))
    grid = make_grid(topology, polyorder, dtype=_torch_dtype(dtype),
                     device=device if device is not None
                     else default_device())
    return DriverConfiguration(name, polyorder, grid, model,
                               config_info=dict(zmax=zmax))
