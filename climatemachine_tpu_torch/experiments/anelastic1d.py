"""The 1-D anelastic box (the port's counterpart of the configuration of
tests/test_atmos_extras.py's ``test_anelastic1d``): a 1000 m cube of 3 ×
3 × 4 elements at p4, float64, lateral sides periodic, a hydrostatic
dry-adiabatic reference state (300 K, 110 K floor),
``ConstantKinematicViscosity(1)``, ``Anelastic1D``, Gravity; T = the
reference's + 0.5 K sin(2πx/1000), u = 2 m/s cos(2πx/1000).  The density
is the reference density for all time, the thermodynamic pressure the
reference pressure, the vertical momentum never moves, and with no
acoustics the step is set by the wind: dt = 0.2 · min_node_distance / 4
m/s, about 100 times the acoustic limit, LSRK54.

:func:`anelastic_box` gives (model, dg, grid, q0, aux0), :func:`stepper`
the step.  CLI::

    python -m climatemachine_tpu_torch.experiments.anelastic1d \\
        --steps 10 --device cpu
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import AtmosBC
from climatemachine_tpu_torch.atmos.compressibility import Anelastic1D
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
from climatemachine_tpu_torch.atmos.sources import Gravity
from climatemachine_tpu_torch.common.turbulence import \
    ConstantKinematicViscosity
from climatemachine_tpu_torch.device import resolve_device
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.mesh.grid import make_grid, min_node_distance
from climatemachine_tpu_torch.mesh.topology import stacked_brick_topology
from climatemachine_tpu_torch.ode.lsrk import LSRK54CarpenterKennedy
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import EARTH
from climatemachine_tpu_torch.physics.temperature_profiles import \
    DryAdiabaticProfile

ps = EARTH

#: the box: L, elements a side, vertical elements, order
L, N, NZ, POLY = 1000.0, 3, 4, 4
#: dt = CFL · min_node_distance / U_MAX (the advective limit)
CFL, U_MAX = 0.2, 4.0


def anelastic_model() -> AtmosModel:
    """The box's AtmosModel (ρ in the initial state is 1: the model
    replaces it with ρ_ref)."""
    physics = AtmosPhysics(
        ref_state=HydrostaticState(DryAdiabaticProfile(300.0, 110.0)),
        turbulence=ConstantKinematicViscosity(1.0),
        compressibility=Anelastic1D())

    def init(m, coords, aux, t):
        x = coords[:, 0]
        p = m.aux_spec.get(aux, "ref_state.p")
        Phi = m.aux_spec.get(aux, "orientation.Phi")
        T = 300.0 * (p / ps.MSLP) ** ps.kappa_d \
            + 0.5 * torch.sin(2 * math.pi * x / 1000.0)
        rho = torch.ones_like(p)
        u = 2.0 * torch.cos(2 * math.pi * x / 1000.0)
        zero = torch.zeros_like(u)
        return m.prog_spec.pack({
            "rho": rho,
            "rhoe": rho * (td.internal_energy(ps, T) + Phi + 0.5 * u ** 2),
            "rhou": torch.stack([rho * u, zero, zero], dim=1)})

    return AtmosModel(physics, AtmosProblem(
        init_state=init, boundary_conditions=(AtmosBC(), AtmosBC())),
        sources=(Gravity(),))


def anelastic_box(device=None):
    """(model, dg, grid, q0, aux0) of the box in float64 on ``device``
    (the card unless "cpu")."""
    ranges = [np.linspace(0.0, L, N + 1)] * 2 + [np.linspace(0.0, L,
                                                            NZ + 1)]
    topo = stacked_brick_topology(ranges, periodicity=(True, True, False),
                                  boundary=np.array([[0, 0], [0, 0],
                                                     [1, 2]]))
    grid = make_grid(topo, POLY, dtype=torch.float64,
                     device=resolve_device(device))
    model = anelastic_model()
    dg = DGModel(model, grid)
    q0, aux0 = init_ode_state(dg)
    return model, dg, grid, q0, aux0


def stepper(dg, grid):
    """(LSRK54 step, dt) at the advective dt."""
    dt = CFL * min_node_distance(grid) / U_MAX
    return LSRK54CarpenterKennedy(dg, dt).step, dt


def main(argv=None):
    ap = argparse.ArgumentParser(description="the 1-D anelastic box")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    model, dg, grid, q, aux = anelastic_box(args.device)
    step, dt = stepper(dg, grid)
    rho_ref = model.aux_spec.get(aux, "ref_state.rho")
    for i in range(args.steps):
        q, aux = step(q, aux, i * dt)
    sp = model.prog_spec
    print(f"dt = {dt:.3f} s ({dt / (min_node_distance(grid) / 350.0):.1f} "
          f"× the acoustic limit)   max |ρ − ρ_ref|/ρ_ref: "
          f"{((sp.get(q, 'rho') - rho_ref).abs() / rho_ref).max().item():.1e}"
          f"   max |ρw|: {sp.get(q, 'rhou')[:, 2].abs().max().item():.1e}",
          flush=True)


if __name__ == "__main__":
    main()
