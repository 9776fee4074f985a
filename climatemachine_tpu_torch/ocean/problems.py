"""Ocean problems: initial state, boundary conditions and forcing
bundles (port of ``climatemachine_tpu/ocean/problems.py``: ``Fixed``,
``Rotating``, ``SimpleBox`` with its analytic spindown states
``hb_state`` :62 and ``sw_init_state`` :102, ``OceanGyre`` :123,
``HomogeneousBox`` :170, ``ocean_box_grid`` :192).

Coordinates and states are var-major: coords ``[E, 3, L]``, the state a
problem returns ``[E, n, L]``.  Boundary tags (the reference's
OceanBoxGCMConfiguration): lateral walls 1, the floor 2, the surface 3.
"""

from __future__ import annotations

import math

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from climatemachine_tpu_torch.ocean.core import (FreeSlip, Impenetrable,
                                                 Insulating, KinematicStress,
                                                 NoSlip, OceanBC, Penetrable,
                                                 TemperatureFlux)


class Fixed:
    pass


class Rotating:
    pass


def _expm_ones(M, t: float):
    """exp(M t) · 1 as python floats, in float64 on the host: a 2 × 2 M
    with complex eigenvalues τ ± iω in closed form, e^{τt}(cos ωt I +
    sin ωt (M − τI)/ω); any other by ``torch.linalg.matrix_exp``, whose
    scaling and squaring loses digits as ‖M t‖ grows (1e-11 relative at
    ‖M t‖ ≈ 1e5, the spindown box's 30 days, against 3e-14 for the closed
    form)."""
    M = np.asarray(M, dtype=np.float64)
    if M.shape == (2, 2):
        tau = 0.5 * (M[0, 0] + M[1, 1])
        w2 = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0] - tau * tau
        if w2 > 0.0:
            w = math.sqrt(w2)
            E = math.exp(tau * t) * (math.cos(w * t) * np.eye(2) + math.sin(
                w * t) / w * (M - tau * np.eye(2)))
            return E.sum(axis=1).tolist()
    E = torch.linalg.matrix_exp(torch.tensor(M, dtype=torch.float64) * t)
    return E.sum(dim=1).tolist()


def _state(model, coords, values: dict):
    """A state ``[E, n, L]`` with ``values`` in their slots, 0
    elsewhere."""
    q = coords.new_zeros((coords.shape[0], model.prog_spec.num,
                          coords.shape[-1]))
    for name, v in values.items():
        q[:, model.prog_spec.index(name)] = v.reshape(
            q[:, model.prog_spec.index(name)].shape)
    return q


@dataclass
class SimpleBox:
    """The box of the analytic spindown states (barotropic and
    baroclinic standing waves), without or with rotation."""
    Lx: float
    Ly: float
    H: float
    rotation: object = field(default_factory=Fixed)
    boundary_conditions: Tuple[OceanBC, ...] = (
        OceanBC(Impenetrable(FreeSlip()), Insulating()),
        OceanBC(Penetrable(FreeSlip()), Insulating()),
        OceanBC(Penetrable(FreeSlip()), Insulating()),
    )

    def coriolis_parameter(self, model, y):
        if isinstance(self.rotation, Fixed):
            return torch.zeros_like(y)
        return torch.full_like(y, model.f_o)

    def init_aux(self, model, coords, aux):
        return aux

    def hb_state(self, model, coords, t):
        """(U, V, η, u₀, v₀) ``[E, L]`` each at time t: the barotropic
        transport and surface height of exp(M t)·1, and the baroclinic
        deviation."""
        kx = 2 * np.pi / self.Lx
        kz = 2 * np.pi / self.H
        x, z = coords[:, 0], coords[:, 2]
        gH = model.param_set.grav * self.H
        nu_x, nu_z = model.nu_h, model.nu_z
        lam = nu_x * kx ** 2 + nu_z * kz ** 2
        if isinstance(self.rotation, Fixed):
            A = _expm_ones([[-nu_x * kx ** 2, gH * kx], [-kx, 0.0]], t)
            U = A[0] * torch.sin(kx * x)
            V = torch.zeros_like(U)
            eta = A[1] * torch.cos(kx * x)
            u0 = np.exp(-lam * t) * torch.cos(kz * z) * torch.sin(kx * x)
            v0 = torch.zeros_like(u0)
        else:
            f = model.f_o
            A = _expm_ones([[-nu_x * kx ** 2, f, gH * kx],
                            [-f, -nu_x * kx ** 2, 0.0],
                            [-kx, 0.0, 0.0]], t)
            U = A[0] * torch.sin(kx * x)
            V = A[1] * torch.sin(kx * x)
            eta = A[2] * torch.cos(kx * x)
            Ab = _expm_ones([[-lam, f], [-f, -lam]], t)
            u0 = Ab[0] * torch.cos(kz * z) * torch.sin(kx * x)
            v0 = Ab[1] * torch.cos(kz * z) * torch.sin(kx * x)
        return U, V, eta, u0, v0

    def init_state(self, model, coords, aux, t):
        U, V, eta, u0, v0 = self.hb_state(model, coords, t)
        u = torch.stack([u0 + U / self.H, v0 + V / self.H], dim=1)
        return _state(model, coords, {"u": u, "eta": eta})

    def sw_init_state(self, model, coords, aux, t):
        """The barotropic state alone, for the shallow-water model."""
        kx = 2 * np.pi / self.Lx
        x = coords[:, 0]
        gH = model.param_set.grav * self.H
        nu = getattr(model.turbulence, "nu", 0.0)
        A = _expm_ones([[-nu * kx ** 2, gH * kx], [-kx, 0.0]], t)
        U = A[0] * torch.sin(kx * x)
        eta = A[1] * torch.cos(kx * x)
        return _state(model, coords, {
            "U": torch.stack([U, torch.zeros_like(U)], dim=1), "eta": eta})

    def kinematic_stress(self, y):
        return y.new_zeros((y.shape[0], 2) + y.shape[1:])


@dataclass
class OceanGyre:
    """The wind-driven gyre with surface temperature restoring: wind
    stress τₒ cos(πy/Lʸ), restoring λʳ(θ − θᴱ(1 − y/Lʸ))."""
    Lx: float
    Ly: float
    H: float
    tau_o: float = 1e-1
    lam_r: float = 4.0 / 86400.0
    theta_E: float = 10.0
    boundary_conditions: Tuple[OceanBC, ...] = None

    def __post_init__(self):
        if self.boundary_conditions is None:
            self.boundary_conditions = (
                OceanBC(Impenetrable(NoSlip()), Insulating()),
                OceanBC(Impenetrable(NoSlip()), Insulating()),
                OceanBC(Penetrable(KinematicStress(self._stress)),
                        TemperatureFlux(self._temp_flux)),
            )

    def _stress(self, problem, y, t):
        tau = (self.tau_o / 1000.0) * torch.cos(y * np.pi / self.Ly)
        return torch.stack([tau, torch.zeros_like(tau)], dim=1)

    def _temp_flux(self, problem, y, theta, t):
        theta_r = self.theta_E * (1 - y / self.Ly)
        return self.lam_r * (theta - theta_r)

    def coriolis_parameter(self, model, y):
        return model.f_o + model.beta * y

    def init_aux(self, model, coords, aux):
        return aux

    def init_state(self, model, coords, aux, t):
        y, z = coords[:, 1], coords[:, 2]
        theta = (5 + 4 * torch.cos(y * np.pi / self.Ly)) * (1 + z / self.H)
        return _state(model, coords, {"theta": theta})

    def kinematic_stress(self, y):
        tau = -self.tau_o * torch.cos(np.pi * y / self.Ly)
        return torch.stack([tau, torch.zeros_like(tau)], dim=1)


@dataclass
class HomogeneousBox(OceanGyre):
    """The wind-driven box without temperature forcing."""

    def __post_init__(self):
        if self.boundary_conditions is None:
            self.boundary_conditions = (
                OceanBC(Impenetrable(NoSlip()), Insulating()),
                OceanBC(Impenetrable(NoSlip()), Insulating()),
                OceanBC(Penetrable(KinematicStress(self._stress)),
                        Insulating()),
            )

    def init_state(self, model, coords, aux, t):
        """u = 0, η = 0, θ = 20."""
        return _state(model, coords,
                      {"theta": torch.full_like(coords[:, 0], 20.0)})


def ocean_box_grid(problem, nx: int, ny: int, nz: int, polyorder: int,
                   dtype: torch.dtype = torch.float64, device=None):
    """The stacked brick [0, Lx] × [0, Ly] × [−H, 0] with nx × ny × nz
    elements at ``polyorder`` and the ocean's boundary tags; ``device``
    None means CUDA."""
    from climatemachine_tpu_torch.mesh.grid import make_grid
    from climatemachine_tpu_torch.mesh.topology import stacked_brick_topology
    ranges = [np.linspace(0.0, problem.Lx, nx + 1),
              np.linspace(0.0, problem.Ly, ny + 1),
              np.linspace(-problem.H, 0.0, nz + 1)]
    topo = stacked_brick_topology(
        ranges, periodicity=(False, False, False),
        boundary=np.array([[1, 1], [1, 1], [2, 3]]))
    return make_grid(topo, polyorder, dtype=dtype, device=device)
