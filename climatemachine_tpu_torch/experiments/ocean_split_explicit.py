"""The split-explicit wind-driven gyre (the port's counterpart of
``examples/ocean_split_explicit_box.py``, at the width of the Julia
experiment ``experiments/OceanSplitExplicit/simple_box.jl``): OceanGyre
(4e6 × 4e6 × 1000 m, τₒ = 0.1, λʳ = 10/86400, θᴱ = 10) with
``CoupledHBModel(c_h=1, kappa_c=0.1)`` on 20 × 20 × 20 elements at p4
and ``BarotropicModel(ConstantViscosity(ν_h), advection=None, c=1)``
with the central flux on the walled 20 × 20 brick of the same horizontal
ranges, float64; ``SplitExplicitSolver`` ("new") with LSRK54 slow at dt
= 5400 s and LSRK54 fast at 240 s (24 fast steps a slow step), then
``num_impl_steps`` = 5 IVDC solves at dt/5 (GMRES, 24 Krylov vectors,
2 restarts) after every slow step.  The barotropic state starts at rest.

The IVDC schedule is the 3-D model's own (``num_impl_steps``,
``ivdc_dt``, as the reference's OceanModel carries it), so that its
explicit vertical diffusivity is κᶻ/2 without the convective branch and
the implicit solves carry κᶜ and the other κᶻ/2.  The JAX example keeps
the explicit κᶜ and κᶻ as well and so mixes convection twice (ROADMAP,
reference caveats).

    python -m climatemachine_tpu_torch.experiments.ocean_split_explicit \\
        [--hours H] [--nx N] [--nz N] [--device cpu]

prints, per slow step, max|u| and max|U|, then one JSON line: ms per
slow step with the split-explicit step and the IVDC solves timed apart,
simulated s per wall s, max|u|, max|U|, max|η|, the θ range and every
GMRES residual ‖b − Lx‖/‖b‖.  ``--nx 4 --nz 4`` is the JAX example's CPU size.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from climatemachine_tpu_torch.device import resolve_device
from climatemachine_tpu_torch.dg.numerical_fluxes import \
    CentralNumericalFluxFirstOrder
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.mesh.grid import make_grid
from climatemachine_tpu_torch.mesh.topology import brick_topology
from climatemachine_tpu_torch.ocean.ivdc import ivdc_solve
from climatemachine_tpu_torch.ocean.problems import OceanGyre, ocean_box_grid
from climatemachine_tpu_torch.ocean.shallow_water import ConstantViscosity
from climatemachine_tpu_torch.ocean.split_explicit import (BarotropicModel,
                                                           CoupledHBModel,
                                                           SplitExplicitSolver)
from climatemachine_tpu_torch.ode.lsrk import LSRK54CarpenterKennedy

DOMAIN = (4e6, 4e6, 1000.0)
POLYORDER = 4


def rest_state(model, coords, aux, t):
    """The 2-D state at rest."""
    return coords.new_zeros((coords.shape[0], model.prog_spec.num,
                             coords.shape[-1]))


@dataclass
class SplitExplicitOcean:
    """The configuration built by :func:`make`: both models and
    operators, the solver and the initial state pairs."""
    m3: CoupledHBModel
    m2: BarotropicModel
    dg3: DGModel
    dg2: DGModel
    solver: SplitExplicitSolver
    q: tuple
    aux: tuple


def make(nx: int = 20, nz: int = 20, dt_slow: float = 5400.0,
         dt_fast: float = 240.0, num_impl_steps: int = 5, device=None
         ) -> SplitExplicitOcean:
    """The gyre at nx × nx × nz elements, p4, float64; ``device=None``
    means CUDA."""
    device = resolve_device(device)
    Lx, Ly, H = DOMAIN
    problem = OceanGyre(Lx, Ly, H, tau_o=0.1, lam_r=10.0 / 86400.0,
                        theta_E=10.0)
    m3 = CoupledHBModel(problem, c_h=1.0, kappa_c=0.1,
                        num_impl_steps=num_impl_steps,
                        ivdc_dt=dt_slow / max(num_impl_steps, 1))
    m2 = BarotropicModel(problem, turbulence=ConstantViscosity(m3.nu_h),
                         advection=None, c=1.0)
    grid3 = ocean_box_grid(problem, nx, nx, nz, POLYORDER,
                           dtype=torch.float64, device=device)
    topo2 = brick_topology([np.linspace(0.0, Lx, nx + 1),
                            np.linspace(0.0, Ly, nx + 1)],
                           periodicity=(False, False),
                           boundary=np.array([[1, 1], [1, 1]]))
    grid2 = make_grid(topo2, POLYORDER, dtype=torch.float64, device=device)
    dg3 = DGModel(m3, grid3)
    dg2 = DGModel(m2, grid2,
                  numerical_flux_first_order=CentralNumericalFluxFirstOrder())
    q2, aux2 = init_ode_state(dg2, init_state=rest_state)
    q3, aux3 = init_ode_state(dg3)
    solver = SplitExplicitSolver(LSRK54CarpenterKennedy(dg3, dt_slow),
                                 LSRK54CarpenterKennedy(dg2, dt_fast),
                                 dg3, dg2, dt=dt_slow, fast_dt=dt_fast)
    return SplitExplicitOcean(m3, m2, dg3, dg2, solver, (q3, q2),
                              (aux3, aux2))


def implicit(cfg: SplitExplicitOcean, q3, aux3):
    """The 3-D model's ``num_impl_steps`` IVDC solves at its ``ivdc_dt``
    after a slow step, each in a profiler span ``ivdc``: (q3, [each
    solve's GMRES residual relative to its own right-hand side, 0-d
    tensors])."""
    res = []
    for _ in range(cfg.m3.num_impl_steps):
        with record_function("ivdc"):
            q3, r = ivdc_solve(cfg.m3, cfg.dg3, q3, aux3, cfg.m3.ivdc_dt)
        res.append(r)
    return q3, res


def step(cfg: SplitExplicitOcean, q, aux, t: float, sync=None):
    """One slow step and its IVDC solves from (q, aux) at t: (q, aux, the
    GMRES residuals, the split-explicit step's seconds, the IVDC
    solves' seconds), each timed on the host clock after ``sync()``
    (``torch.cuda.synchronize`` on the card)."""
    sync = sync or (lambda: None)
    sync()
    t0 = time.perf_counter()
    q, aux = cfg.solver.step(q, aux, t)
    sync()
    t1 = time.perf_counter()
    q3, res = implicit(cfg, q[0], aux[0])
    sync()
    return (q3, q[1]), aux, res, t1 - t0, time.perf_counter() - t1


def summary(cfg: SplitExplicitOcean, q) -> dict:
    """max|u|, max|U|, max|η| and the θ range of the state pair."""
    q3, q2 = q
    th = cfg.m3.prog(q3, "theta")
    return dict(max_abs_u=cfg.m3.prog(q3, "u").abs().max().item(),
                max_abs_U=cfg.m2.prog(q2, "U").abs().max().item(),
                max_abs_eta=cfg.m3.prog(q3, "eta").abs().max().item(),
                theta_range=[th.min().item(), th.max().item()],
                finite=bool(torch.isfinite(q3).all())
                and bool(torch.isfinite(q2).all()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hours", type=float, default=6.0)
    ap.add_argument("--nx", type=int, default=20)
    ap.add_argument("--nz", type=int, default=20)
    ap.add_argument("--dt-slow", type=float, default=5400.0)
    ap.add_argument("--dt-fast", type=float, default=240.0)
    ap.add_argument("--num-impl-steps", type=int, default=5)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    cfg = make(args.nx, args.nz, dt_slow=args.dt_slow,
               dt_fast=args.dt_fast, num_impl_steps=args.num_impl_steps,
               device=args.device)
    on_card = cfg.dg3.grid.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else None
    q, aux, t = cfg.q, cfg.aux, 0.0
    nsteps = max(int(args.hours * 3600 / args.dt_slow), 1)
    split_s, ivdc_s, residuals = [], [], []
    for _ in range(nsteps):
        q, aux, res, ts, ti = step(cfg, q, aux, t, sync)
        t += args.dt_slow
        split_s.append(ts)
        ivdc_s.append(ti)
        residuals.append([r.item() for r in res])
        s = summary(cfg, q)
        print(f"t = {t / 3600.0:7.2f} h   max|u| = {s['max_abs_u']:.5f} "
              f"m/s   max|U| = {s['max_abs_U']:.4f} m^2/s", flush=True)
    wall = sum(split_s) + sum(ivdc_s)
    out = dict(elements_3d=cfg.dg3.grid.nelem,
               elements_2d=cfg.dg2.grid.nelem, steps=nsteps,
               fast_steps_per_slow_step=sum(cfg.solver.fast_steps()),
               ms_per_slow_step=1e3 * wall / nsteps,
               split_explicit_ms=1e3 * sum(split_s) / nsteps,
               ivdc_ms=1e3 * sum(ivdc_s) / nsteps,
               sim_s_per_wall_s=args.dt_slow * nsteps / wall,
               gmres_residuals=residuals, **summary(cfg, q))
    print(json.dumps(out), flush=True)
    if not out["finite"]:
        raise SystemExit("the state is not finite")


if __name__ == "__main__":
    main()
