"""The EDMF single stack (the port's counterpart of
``examples/bomex_edmf.py``): the stable boundary layer of one 20 m × 20
m column to 400 m, 15 elements at p4 in float64, θ = 265 K to 100 m then
+0.01 K/m on the hydrostatic dry-adiabatic reference pressure, u = 8
m/s, ``ConstantKinematicViscosity(0)`` (the gradient pass EDMF rides)
and ``EDMF(N_up=1, NeutralDrySurfaceModel())``; LSRK144 at dt = 0.4 ·
min_node_distance / 340, TMAR on the EDMF lanes (all but ρaw) after
every step.

Cases (:data:`CASES`): "decoupled" (the example), "coupled" (the SGS
fluxes fed back on the grid mean: the stored-profile gate's case) and
"moist" (two updrafts over the BOMEX surface with an Obukhov length of
−100 m, ``EquilMoist``, q_tot = 10⁻³).  :func:`sbl_stack` builds a case,
:func:`stepper` gives its step.  CLI::

    python -m climatemachine_tpu_torch.experiments.bomex_edmf \\
        --timeend 0.5 --nelem-vert 5 --device cpu
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import AtmosBC
from climatemachine_tpu_torch.atmos.edmf import (EDMF, Coupled,
                                                 NeutralDrySurfaceModel,
                                                 SurfaceModel)
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.moisture import DryModel, EquilMoist
from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
from climatemachine_tpu_torch.atmos.sources import Gravity
from climatemachine_tpu_torch.common.turbulence import \
    ConstantKinematicViscosity
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.device import resolve_device
from climatemachine_tpu_torch.mesh.filters import tmar
from climatemachine_tpu_torch.mesh.grid import make_grid, min_node_distance
from climatemachine_tpu_torch.mesh.topology import single_stack_topology
from climatemachine_tpu_torch.ode.lsrk import LSRK144NiegemannDiehlBusch
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import EARTH
from climatemachine_tpu_torch.physics.temperature_profiles import \
    DryAdiabaticProfile

ps = EARTH

#: the example's column: [0, HMAX]² × [0, ZMAX] in NELEM_VERT elements
HMAX, ZMAX, NELEM_VERT, POLY = 20.0, 400.0, 15, 4
#: dt = CFL · min_node_distance / SPEED
CFL, SPEED = 0.4, 340.0
#: the moist case's total water
Q_TOT = 1e-3


@dataclass(frozen=True)
class EDMFCase:
    edmf: Callable[[], EDMF]
    moist: bool = False


CASES = {
    "decoupled": EDMFCase(lambda: EDMF(N_up=1,
                                       surface=NeutralDrySurfaceModel())),
    "coupled": EDMFCase(lambda: EDMF(N_up=1,
                                     surface=NeutralDrySurfaceModel(),
                                     coupling=Coupled())),
    "moist": EDMFCase(lambda: EDMF(N_up=2, surface=SurfaceModel(
        obukhov_length=-100.0)), moist=True),
}


def sbl_model(edmf: EDMF, moist: bool = False) -> AtmosModel:
    """The stable-boundary-layer AtmosModel with ``edmf`` as its
    ``turbconv``."""
    physics = AtmosPhysics(
        ref_state=HydrostaticState(DryAdiabaticProfile(265.0, 110.0)),
        turbulence=ConstantKinematicViscosity(0.0),
        moisture=EquilMoist() if moist else DryModel(), turbconv=edmf)

    def init(m, coords, aux, t):
        z = coords[:, 2]
        p = m.aux_spec.get(aux, "ref_state.p")
        Phi = m.aux_spec.get(aux, "orientation.Phi")
        theta = 265.0 + 0.01 * torch.clamp_min(z - 100.0, 0.0)
        T = theta * (p / ps.MSLP) ** ps.kappa_d
        rho = p / (ps.R_d * T)
        u = torch.full_like(rho, 8.0)
        zero = torch.zeros_like(u)
        fields = {"rho": rho,
                  "rhoe": rho * (td.internal_energy(ps, T) + Phi
                                 + 0.5 * 64.0),
                  "rhou": torch.stack([rho * u, zero, zero], dim=1)}
        if moist:
            fields["moisture.rhoq_tot"] = rho * Q_TOT
        return m.prog_spec.pack(fields)

    return AtmosModel(physics,
                      AtmosProblem(init_state=init,
                                   boundary_conditions=(AtmosBC(),
                                                        AtmosBC())),
                      sources=(Gravity(),))


def sbl_stack(case: str = "decoupled", nelem_vert: int = NELEM_VERT,
              zmax: float = ZMAX, device=None):
    """(model, dg, grid, q0, aux0) of ``case`` on the single stack of
    ``nelem_vert`` elements to ``zmax``, float64 on ``device`` (the card
    unless "cpu")."""
    c = CASES[case]
    topo = single_stack_topology(HMAX, HMAX,
                                 np.linspace(0.0, zmax, nelem_vert + 1))
    grid = make_grid(topo, POLY, dtype=torch.float64,
                     device=resolve_device(device))
    model = sbl_model(c.edmf(), c.moist)
    dg = DGModel(model, grid)
    q0, aux0 = init_ode_state(dg)
    return model, dg, grid, q0, aux0


def tmar_slots(model) -> list:
    """The lanes TMAR filters: every ``turbconv.`` lane but ρaw."""
    return [i for i, n in enumerate(model.prog_spec.flattened_names())
            if n.startswith("turbconv.") and "rhoaw" not in n]


def stepper(model, dg, grid, dt=None):
    """(step(q, aux, t) → (q, aux), dt): one LSRK144 step of ``dg`` at dt
    (CFL · min_node_distance / SPEED by default), then TMAR on
    :func:`tmar_slots`."""
    if dt is None:
        dt = CFL * min_node_distance(grid) / SPEED
    solver = LSRK144NiegemannDiehlBusch(dg, dt)
    slots = tmar_slots(model)

    def step(q, aux, t):
        q, aux = solver.step(q, aux, t)
        return tmar(grid, q, fields=slots), aux

    return step, dt


def main(argv=None):
    ap = argparse.ArgumentParser(description="the EDMF single stack")
    ap.add_argument("--timeend", type=float, default=30.0)
    ap.add_argument("--zmax", type=float, default=ZMAX)
    ap.add_argument("--nelem-vert", type=int, default=NELEM_VERT)
    ap.add_argument("--case", default="decoupled", choices=sorted(CASES))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    model, dg, grid, q, aux = sbl_stack(args.case, args.nelem_vert,
                                        args.zmax, args.device)
    step, dt = stepper(model, dg, grid)
    t, nsteps = 0.0, int(args.timeend / dt)
    for _ in range(nsteps):
        q, aux = step(q, aux, t)
        t += dt
    sp = model.prog_spec
    z = model.aux_spec.get(aux, "coord")[:, 2]
    tke = sp.get(q, "turbconv.en_rhoatke")
    rhoa = sp.get(q, "turbconv.up_rhoa")[:, 0]
    low = z < 40
    print(f"t = {t:.1f} s ({nsteps} steps)")
    print(f"surface TKE (z<40m):  {tke[low].mean().item():.4f} kg/m/s^2")
    print(f"updraft area (z<40m): {rhoa[low].mean().item():.5f}")


if __name__ == "__main__":
    main()
