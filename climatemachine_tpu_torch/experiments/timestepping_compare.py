"""One configuration through the time-integrator menu (the port's
counterpart of ``examples/timestepping_compare.py``, the reference's
tutorials/Numerics/TimeStepping).

A small dry rising bubble (a 2 K bubble of radius 500 m at (1250, 1000)
m in a 2500 m cube, no closure, Gravity, p4, float64) on an anisotropic
grid, Δz = Δx/5, so that the every-direction acoustic limit is
vertical, the regime the HEVI and multirate schemes target.  Each
solver steps it to ``timeend``: LSRK54 at Courant 0.4, LSRK144 at 0.8,
SSPRK33 at 0.25, IMEX ARK2 with the column solve at 2.0, the multirate
RK (8 fast steps a slow one) at 2.4 and MIS2 (8 substeps) at 2.4, in
units of dt_acoustic = min_node_distance / 350 m/s; each is compared
with LSRK54 at 0.1 (the control) by max|q − q_ctrl| over the control's
range max|q_ctrl − q0|, which must stay below 0.5 (on every device
through the plain operator: :func:`run_menu`).  ::

    python -m climatemachine_tpu_torch.experiments.timestepping_compare \\
        [--timeend 50] [--resolution 125] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import AtmosBC
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
from climatemachine_tpu_torch.atmos.sources import Gravity
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.driver.configs import AtmosLESConfiguration
from climatemachine_tpu_torch.driver.solver_types import (
    ExplicitSolverType, IMEXSolverType, MISSolverType, MultirateSolverType)
from climatemachine_tpu_torch.mesh.grid import min_node_distance
from climatemachine_tpu_torch.ode.lsrk import LSRK144NiegemannDiehlBusch
from climatemachine_tpu_torch.ode.mis import MIS2
from climatemachine_tpu_torch.ode.solve import solve
from climatemachine_tpu_torch.ode.ssprk import SSPRK33ShuOsher
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import EARTH
from climatemachine_tpu_torch.physics.temperature_profiles import \
    DryAdiabaticProfile

TIMEEND, RESOLUTION = 50.0, 125.0
CONTROL_COURANT = 0.1
ERR_LIMIT = 0.5
#: (name, solver type, dt over dt_acoustic)
MENU = (
    ("LSRK54 (CFL 0.4)", ExplicitSolverType(state_layout="grid"), 0.4),
    ("LSRK144 (CFL 0.8)", ExplicitSolverType(
        solver_method=LSRK144NiegemannDiehlBusch, state_layout="grid"), 0.8),
    ("SSPRK33 (CFL 0.25)", ExplicitSolverType(
        solver_method=SSPRK33ShuOsher, state_layout="grid"), 0.25),
    ("IMEX ARK2+columnwise (4x)",
     IMEXSolverType(columnwise_solver="dense"), 2.0),
    ("Multirate RK (slow/fast 8x)", MultirateSolverType(timestep_ratio=8),
     2.4),
    ("MIS2 (8 substeps)", MISSolverType(mis_method=MIS2, nsubsteps=8), 2.4))


def compare_model() -> AtmosModel:
    ps = EARTH
    physics = AtmosPhysics(
        ref_state=HydrostaticState(DryAdiabaticProfile(300.0, 110.0)))

    def init(m, coords, aux, t):
        x, z = coords[:, 0], coords[:, 2]
        p = m.aux_spec.get(aux, "ref_state.p")
        r = torch.sqrt((x - 1250.0) ** 2 + (z - 1000.0) ** 2)
        dtheta = 2.0 * torch.clamp(1 - r / 500.0, 0.0, 1.0)
        T = (300.0 + dtheta) * (p / ps.MSLP) ** ps.kappa_d
        rho = p / (ps.R_d * T)
        Phi = m.aux_spec.get(aux, "orientation.Phi")
        return m.prog_spec.pack(
            {"rho": rho, "rhoe": rho * (td.internal_energy(ps, T) + Phi)})

    return AtmosModel(physics, AtmosProblem(
        init_state=init, boundary_conditions=(AtmosBC(), AtmosBC())),
        sources=(Gravity(),))


def compare_config(resolution: float = RESOLUTION, device=None):
    """``AtmosLESConfiguration("ts_compare", 4, (Δ, Δ, Δ/5), ...)`` of the
    2500 m cube (5 × 5 × 25 elements at Δ = 125 m) in float64, as the
    example's."""
    return AtmosLESConfiguration(
        "ts_compare", 4, (resolution, resolution, resolution / 5),
        2500.0, 2500.0, 2500.0, compare_model(), dtype=torch.float64,
        device=device)


def compare_dg(dc) -> DGModel:
    """The DG operator of every run: the plain volume and LDG stages,
    which take float64."""
    return DGModel(dc.model, dc.grid, volume_kernel="xla",
                   ldg_kernel="varmajor")


def run_menu(timeend: float = TIMEEND, resolution: float = RESOLUTION,
             device=None, menu=MENU):
    """The control and each solver of ``menu`` to ``timeend``.  Returns
    (rows, dt_acoustic): per solver its name, dt over dt_acoustic, steps,
    error against the control, wall seconds and finiteness.

    The comparison needs float64: its errors are relative to the small
    range the control moves the state by, below float32's resolution of
    ρe (at the default resolution to 10 s float32 gives 0.75-0.96 on an
    H100).  The card's kernels take float32 only, so on every device the
    explicit steps run the generic operator's plain stages ("grid",
    :func:`compare_dg`) and the IMEX step the dense column solver (the
    banded one's layout kernels are float32 too)."""
    dc = compare_config(resolution, device)
    dg = compare_dg(dc)
    q0, aux0 = init_ode_state(dg)
    dt_ac = float(min_node_distance(dc.grid)) / 350.0
    sync = (torch.cuda.synchronize if q0.device.type == "cuda"
            else lambda: None)

    def timed(solver):
        sync()
        t0 = time.perf_counter()
        q = solve(q0, aux0, solver, timeend).q
        sync()
        return q, time.perf_counter() - t0

    q_ctrl, wall = timed(ExplicitSolverType(state_layout="grid").make(
        dg, q0, aux0, CONTROL_COURANT * dt_ac))
    scale = (q_ctrl - q0).abs().max().item() + 1e-300
    rows = [dict(name="control LSRK54 (CFL 0.1)", cfl=CONTROL_COURANT,
                 steps=math.ceil(timeend / (CONTROL_COURANT * dt_ac)
                                 - 1e-12),
                 err=0.0, seconds=wall,
                 finite=bool(torch.isfinite(q_ctrl).all()))]
    for name, solver_type, cfl in menu:
        q, wall = timed(solver_type.make(dg, q0, aux0, cfl * dt_ac))
        rows.append(dict(name=name, cfl=cfl,
                         steps=math.ceil(timeend / (cfl * dt_ac) - 1e-12),
                         err=(q - q_ctrl).abs().max().item() / scale,
                         seconds=wall, finite=bool(torch.isfinite(q).all())))
    return rows, dt_ac


def check(rows):
    """The example's assertions: every state finite, every error below
    ERR_LIMIT."""
    for r in rows:
        if not r["finite"] or not r["err"] < ERR_LIMIT:
            raise AssertionError((r["name"], r["err"], r["finite"]))


def main(argv=None):
    ap = argparse.ArgumentParser(description="the time-integrator menu")
    ap.add_argument("--timeend", type=float, default=TIMEEND)
    ap.add_argument("--resolution", type=float, default=RESOLUTION)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    rows, _ = run_menu(args.timeend, args.resolution, args.device)
    print(f"{'solver':30s} {'dt/dt_ac':>8s} {'steps':>6s} "
          f"{'max|q-ctrl|/range':>18s} {'s':>8s}")
    for r in rows:
        print(f"{r['name']:30s} {r['cfl']:8.2f} {r['steps']:6d} "
              f"{r['err']:18.3e} {r['seconds']:8.2f}", flush=True)
    check(rows[1:])


if __name__ == "__main__":
    main()
