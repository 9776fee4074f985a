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

The split01 variants at the Julia reference's constants
(tests/test_simple_box_ivd_refvals.py:41-96, simple_box_ivd.jl): OceanGyre
with τₒ = 0.2, λʳ = 20/86400 and θᴱ = 10, ``CoupledHBModel(c_h=1)`` with
the IVDC schedule and ``add_fast_substeps`` on the 3-D model, the
barotropic model's Coriolis from it and the default (Rusanov) flux on the
2-D brick: :func:`make_julia` ("split01": LSRK54 at 5400 / 240 s, 2
added substeps, 5 IVDC solves; ``num_impl_steps=0`` is simple_box_2dt;
"split01_3n": LS3NRK33Heuns3N at 2400 / 120 s, 3 added substeps, 5 IVDC
solves) and :func:`make_dbl_gyre` (simple_dbl_gyre.jl, tests/
test_simple_box_ivd_refvals.py:241-279).  :func:`julia_fields` gives the
statistics the Julia tables hold.  ``--variant split01`` (or
``split01_3n``) runs one of them from the command line.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass

import numpy as np
import torch

from climatemachine_tpu_torch.device import resolve_device
from climatemachine_tpu_torch.dg.numerical_fluxes import \
    CentralNumericalFluxFirstOrder
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.mesh.grid import make_grid
from climatemachine_tpu_torch.mesh.topology import brick_topology
from climatemachine_tpu_torch.ocean.problems import OceanGyre, ocean_box_grid
from climatemachine_tpu_torch.ocean.shallow_water import ConstantViscosity
from climatemachine_tpu_torch.ocean.split_explicit import (BarotropicModel,
                                                           CoupledHBModel,
                                                           SplitExplicitSolver)
from climatemachine_tpu_torch.ode.lsrk import LSRK54CarpenterKennedy
from climatemachine_tpu_torch.ode.lsrk3n import LS3NRK33Heuns3N

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


def _assemble(problem, m3: CoupledHBModel, nx: int, ny: int, nz: int,
              dt_slow: float, dt_fast: float, variant: str, central: bool,
              device) -> SplitExplicitOcean:
    """The barotropic model (its Coriolis from ``m3``), both grids at p4
    in float64 on ``device``, the operators, the state pairs (the 2-D one
    at rest) and the solver: LSRK54 slow and fast, or LS3NRK33Heuns3N
    both for "split01_3n"."""
    device = resolve_device(device)
    m2 = BarotropicModel(problem, turbulence=ConstantViscosity(m3.nu_h),
                         advection=None, c=1.0, f_o=m3.f_o, beta=m3.beta)
    grid3 = ocean_box_grid(problem, nx, ny, nz, POLYORDER,
                           dtype=torch.float64, device=device)
    topo2 = brick_topology([np.linspace(0.0, problem.Lx, nx + 1),
                            np.linspace(0.0, problem.Ly, ny + 1)],
                           periodicity=(False, False),
                           boundary=np.array([[1, 1], [1, 1]]))
    grid2 = make_grid(topo2, POLYORDER, dtype=torch.float64, device=device)
    dg3 = DGModel(m3, grid3)
    dg2 = DGModel(m2, grid2, numerical_flux_first_order=(
        CentralNumericalFluxFirstOrder() if central else None))
    q2, aux2 = init_ode_state(dg2, init_state=rest_state)
    q3, aux3 = init_ode_state(dg3)
    method = LS3NRK33Heuns3N if variant == "split01_3n" \
        else LSRK54CarpenterKennedy
    solver = SplitExplicitSolver(method(dg3, dt_slow), method(dg2, dt_fast),
                                 dg3, dg2, dt=dt_slow, fast_dt=dt_fast,
                                 variant=variant)
    return SplitExplicitOcean(m3, m2, dg3, dg2, solver, (q3, q2),
                              (aux3, aux2))


def make(nx: int = 20, nz: int = 20, dt_slow: float = 5400.0,
         dt_fast: float = 240.0, num_impl_steps: int = 5, device=None
         ) -> SplitExplicitOcean:
    """The gyre at nx × nx × nz elements, p4, float64, the "new" variant;
    ``device=None`` means CUDA."""
    Lx, Ly, H = DOMAIN
    problem = OceanGyre(Lx, Ly, H, tau_o=0.1, lam_r=10.0 / 86400.0,
                        theta_E=10.0)
    m3 = CoupledHBModel(problem, c_h=1.0, kappa_c=0.1,
                        num_impl_steps=num_impl_steps,
                        ivdc_dt=dt_slow / max(num_impl_steps, 1))
    return _assemble(problem, m3, nx, nx, nz, dt_slow, dt_fast, "new",
                     central=True, device=device)


#: the Julia simple_box configurations of the split01 variants: slow and
#: fast dt, the added fast substeps and the IVDC solves a slow step
JULIA = {"split01": dict(dt_slow=5400.0, dt_fast=240.0,
                         add_fast_substeps=2, num_impl_steps=5),
         "split01_3n": dict(dt_slow=2400.0, dt_fast=120.0,
                            add_fast_substeps=3, num_impl_steps=5)}


def make_julia(variant: str = "split01", nx: int = 20, nz: int = 20,
               num_impl_steps: int = None, device=None
               ) -> SplitExplicitOcean:
    """simple_box_ivd ("split01"), simple_box_2dt ("split01" with
    ``num_impl_steps=0``) or simple_box_rk3 ("split01_3n") at nx × nx ×
    nz elements over 4e6 × 4e6 × 1000 m."""
    c = dict(JULIA[variant])
    if num_impl_steps is not None:
        c["num_impl_steps"] = num_impl_steps
    Lx, Ly, H = DOMAIN
    problem = OceanGyre(Lx, Ly, H, tau_o=2e-1, lam_r=20.0 / 86400.0,
                        theta_E=10.0)
    m3 = CoupledHBModel(problem, c_h=1.0,
                        num_impl_steps=c["num_impl_steps"],
                        ivdc_dt=c["dt_slow"] / max(c["num_impl_steps"], 1),
                        add_fast_substeps=c["add_fast_substeps"])
    return _assemble(problem, m3, nx, nx, nz, c["dt_slow"], c["dt_fast"],
                     variant, central=False, device=device)


class DoubleGyreBox(OceanGyre):
    """The double gyre of simple_dbl_gyre.jl:50-78: wind stress
    τₒ cos(2πy/Lʸ), initial θ = (12 + 10 cos(πy/Lʸ))(1 + z/H)."""

    def _stress(self, problem, y, t):
        tau = (self.tau_o / 1000.0) * torch.cos(2 * np.pi * y / self.Ly)
        return torch.stack([tau, torch.zeros_like(tau)], dim=1)

    def init_state(self, model, coords, aux, t):
        y, z = coords[:, 1], coords[:, 2]
        theta = (12 + 10 * torch.cos(y * np.pi / self.Ly)) * (1 + z / self.H)
        q = coords.new_zeros((coords.shape[0], model.prog_spec.num,
                              coords.shape[-1]))
        q[:, model.prog_spec.index("theta")] = theta[:, None]
        return q


#: the double gyre's slow and fast dt
DBL_GYRE_DT = (3456.0, 96.0)


def make_dbl_gyre(nx: int = 20, ny: int = 30, nz: int = 15, device=None
                  ) -> SplitExplicitOcean:
    """simple_dbl_gyre.jl (constants :496-530, the OceanModel overrides
    :182-187) on "split01_3n": 4e6 × 6e6 × 3000 m at nx × ny × nz."""
    dt_slow, dt_fast = DBL_GYRE_DT
    problem = DoubleGyreBox(4e6, 6e6, 3000.0, tau_o=1e-1,
                            lam_r=20.0 / 86400.0, theta_E=25.0)
    m3 = CoupledHBModel(problem, c_h=1.0, nu_h=15e3, nu_z=5e-3,
                        kappa_h=1e3, kappa_z=1e-4, kappa_c=1.0, f_o=3.8e-5,
                        beta=1.7e-11, num_impl_steps=5,
                        ivdc_dt=dt_slow / 5.0, add_fast_substeps=3)
    return _assemble(problem, m3, nx, ny, nz, dt_slow, dt_fast,
                     "split01_3n", central=False, device=device)


def julia_fields(cfg: SplitExplicitOcean, q, aux) -> dict:
    """{(table label, field): [min, max, mean, std (ddof 1)]} in float64
    on the host: the statistics of the Julia simple_box tables, keyed as
    tests/refvals/simple_box_ivd.py keys them."""
    m3, m2 = cfg.m3, cfg.m2
    (q3, q2), (aux3, aux2) = q, aux
    pairs = []
    for i in (0, 1):
        k = f"[{i + 1}]"
        pairs += [(("oce Q_3D", "u" + k), m3.prog(q3, "u")[:, i]),
                  (("oce aux", "u_d" + k), m3.aux_get(aux3, "ud")[:, i]),
                  (("oce aux", "ΔGu" + k), m3.aux_get(aux3, "dGu")[:, i]),
                  (("baro Q_2D", "U" + k), m2.prog(q2, "U")[:, i]),
                  (("baro aux", "Gᵁ" + k), m2.aux_get(aux2, "GU")[:, i]),
                  (("baro aux", "Δu" + k), m2.aux_get(aux2, "du")[:, i]),
                  (("baro aux", "U_c" + k), m2.aux_get(aux2, "U_c")[:, i]),
                  (("baro aux", "U_s" + k), m2.aux_get(aux2, "U_s")[:, i])]
    pairs += [(("oce Q_3D", "η"), m3.prog(q3, "eta")),
              (("oce Q_3D", "θ"), m3.prog(q3, "theta")),
              (("baro Q_2D", "η"), m2.prog(q2, "eta"))]
    pairs += [(("oce aux", name), m3.aux_get(aux3, name))
              for name in ("w", "pkin", "wz0", "y")]
    pairs += [(("baro aux", label), m2.aux_get(aux2, name))
              for name, label in (("eta_c", "η_c"), ("eta_s", "η_s"),
                                  ("eta_diag", "η_diag"), ("deta", "Δη"),
                                  ("y", "y"))]
    out = {}
    for key, x in pairs:
        a = x.detach().double().cpu().numpy()
        out[key] = [float(a.min()), float(a.max()), float(a.mean()),
                    float(a.std(ddof=1))]
    return out


def step(cfg: SplitExplicitOcean, q, aux, t: float, sync=None):
    """One slow step and its IVDC solves from (q, aux) at t: (q, aux, the
    GMRES residuals, the split-explicit step's seconds, the IVDC
    solves' seconds), each timed on the host clock after ``sync()``
    (``torch.cuda.synchronize`` on the card).  For every variant the
    same as ``cfg.solver.step`` followed, for "new", by the IVDC solves
    that the split01 variants run inside it (each in a profiler span
    ``ivdc``)."""
    sync = sync or (lambda: None)
    sync()
    t0 = time.perf_counter()
    q, aux = cfg.solver.explicit_step(q, aux, t)
    sync()
    t1 = time.perf_counter()
    q3, res = cfg.solver.implicit_step(q[0], aux[0])
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
    ap.add_argument("--variant", default="new", choices=("new",) + tuple(
        JULIA), help="split01 and split01_3n at the Julia constants "
        "(their own dts and IVDC solves; --dt-slow, --dt-fast and "
        "--num-impl-steps apply to \"new\" only)")
    args = ap.parse_args(argv)
    if args.variant == "new":
        cfg = make(args.nx, args.nz, dt_slow=args.dt_slow,
                   dt_fast=args.dt_fast, num_impl_steps=args.num_impl_steps,
                   device=args.device)
    else:
        cfg = make_julia(args.variant, args.nx, args.nz, device=args.device)
        args.dt_slow = cfg.solver.dt
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
