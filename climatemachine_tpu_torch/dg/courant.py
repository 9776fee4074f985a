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


def nondiffusive_courant(model, q, aux, dt, delta_x, direction="every"):
    """The model's own non-diffusive Courant number per node:
    ``AtmosModel.nondiffusive_courant``, (|u| + c) dt / Δx, or a linear
    model's (atmos/linear.py, the IMEX solver type's dt model), c dt / Δx
    with the reference state's sound speed."""
    return model.nondiffusive_courant(q, aux, dt, delta_x, direction)


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
