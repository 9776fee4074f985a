"""Courant numbers and the CFL time step (port of
``climatemachine_tpu/dg/courant.py`` :18-73: ``nondiffusive_courant``,
``advective_courant``, ``diffusive_courant``, ``courant`` and
``calculate_dt``).

Local Courant numbers are nodal ``[E, Np]`` tensors of var-major state;
the global one is their maximum, a host float.
"""

from __future__ import annotations

import torch

from climatemachine_tpu_torch.mesh.grid import min_node_distance
from climatemachine_tpu_torch.physics import thermodynamics as td


def nondiffusive_courant(model, q, aux, dt, delta_x, direction="every"):
    """(|u| + c) dt / Δx per node, |u| the speed along the direction
    ("vertical": along ∇Φ; "horizontal": across it), c the dry sound
    speed."""
    T, _, u, _ = model.thermo_full(q, aux)
    if direction == "every":
        speed = torch.linalg.vector_norm(u, dim=1)
    else:
        k = (model.aux_spec.get(aux, "orientation.grad_Phi")
             / model.param_set.grav)
        un = torch.sum(u * k, dim=1, keepdim=True)
        speed = (torch.abs(un[:, 0]) if direction == "vertical"
                 else torch.linalg.vector_norm(u - un * k, dim=1))
    return (speed + td.soundspeed_air(model.param_set, T)) * dt / delta_x


def advective_courant(model, q, aux, dt, delta_x, direction="every"):
    """|u| dt / Δx per node."""
    sp = model.prog_spec
    u = sp.get(q, "rhou") / sp.get(q, "rho")[:, None]
    return torch.linalg.vector_norm(u, dim=1) * dt / delta_x


def diffusive_courant(model, q, aux, dt, delta_x, direction="every"):
    """max_i ν_i dt / Δx² per node from the closure's viscosity (0
    without a closure, or for one whose viscosity reads the gradient
    flux, which a Courant estimate does not have; the JAX package's
    lists only SmagorinskyLilly and Vreman, and fails on AnisoMinDiss)."""
    turb = model.physics.turbulence
    if turb is None or turb.viscosity_needs_gradient_flux:
        return q.new_zeros((q.shape[0], q.shape[2]))
    nu, _ = turb.viscosity(model, q, None, aux, 0.0)
    return torch.amax(nu, dim=1) * dt / (delta_x ** 2)


def courant(local_courant, model, grid, q, aux, dt,
            direction: str = "every") -> float:
    """The largest local Courant number, Δx the minimum node distance
    along ``direction``."""
    dx = min_node_distance(grid, direction)
    return float(torch.max(local_courant(model, q, aux, dt, dx, direction)))


def calculate_dt(grid, model, q, aux, courant_number: float,
                 direction: str = "every",
                 local_courant=nondiffusive_courant) -> float:
    """The dt at which the largest local Courant number is
    ``courant_number``."""
    return courant_number / courant(local_courant, model, grid, q, aux, 1.0,
                                    direction)
