"""Shared set-up of the isentropic-vortex parity tests
(test_torch_vortex.py): the port's copy of the vortex's exact solution
(the JAX package's lives in tests/test_isentropic_vortex.py:36-56), and
the port's model, grid and DGModel built as that test's ``_setup``
builds the JAX ones: a periodic brick on [−L, L]³, p4, NoOrientation
and the AtmosPhysics default NoReferenceState, dry Euler, no sources."""

import numpy as np
import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import AtmosBC
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.common.orientations import NoOrientation
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.mesh.grid import make_grid
from climatemachine_tpu_torch.mesh.topology import brick_topology
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import EARTH

PS = EARTH
P_INF = 1e5
T_INF = 300.0
RHO_INF = P_INF / (PS.R_d * T_INF)
U_T = 150.0                     # translation speed
ALPHA = np.pi / 4
U_V = 50.0                      # vortex speed
R_V = 1.0 / 200                 # vortex radius
L = 1.0 / 20                    # domain half-length


def vortex_state(model, coords, t):
    """The exact state ``[E, 5, Np]`` at time t of coords ``[E, 3, Np]``."""
    u_inf = (U_T * np.cos(ALPHA), U_T * np.sin(ALPHA))
    x = [coords[:, d] - u_inf[d] * t for d in range(2)]
    x = [xd - torch.floor((xd + L) / (2 * L)) * 2 * L for xd in x]
    r2 = x[0] ** 2 + x[1] ** 2
    gauss = torch.exp(-r2 / R_V ** 2 / 2.0)
    u = torch.stack([u_inf[0] - U_V * x[1] / R_V * gauss,
                     u_inf[1] + U_V * x[0] / R_V * gauss,
                     torch.zeros_like(gauss)], dim=1)
    T = T_INF * (1 - PS.kappa_d * U_V ** 2 / 2 * RHO_INF / P_INF
                 * torch.exp(-r2 / R_V ** 2))
    p = P_INF * (T / T_INF) ** (1.0 / PS.kappa_d)
    rho = p / (PS.R_d * T)
    rhoe = rho * (td.internal_energy(PS, T) + 0.5 * torch.sum(u * u, dim=1))
    return torch.cat([rho[:, None], rho[:, None] * u, rhoe[:, None]], dim=1)


def setup(ne, poly, nf=None, nz=1, dtype=torch.float64, device="cpu"):
    """(model, grid, dg, q0, aux0) of the vortex on an ne × ne × nz
    periodic brick, numerical flux ``nf`` (None: Rusanov)."""
    r = [np.linspace(-L, L, ne + 1)] * 2 + [np.linspace(-L, L, nz + 1)]
    grid = make_grid(brick_topology(r, periodicity=(True, True, True)), poly,
                     dtype=dtype, device=device)
    model = AtmosModel(
        AtmosPhysics(orientation=NoOrientation()),
        AtmosProblem(init_state=lambda m, c, aux, t: vortex_state(m, c, t),
                     boundary_conditions=(AtmosBC(),)))
    dg = DGModel(model, grid, numerical_flux_first_order=nf)
    q0, aux0 = init_ode_state(dg)
    return model, grid, dg, q0, aux0
