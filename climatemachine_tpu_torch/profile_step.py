"""Where the Held-Suarez step, or the moist baroclinic wave's, the LES
bubble's, a forced LES case's, the ocean box's or the split-explicit
ocean's, spends its time on the card.

    python -m climatemachine_tpu_torch.profile_step [--steps N] [--out DIR]
        [--no-hyperdiffusion] [--imex] [--surface-kernel {xla,hybrid,pallas}]
        [--grid] [--dense] [--moist] [--dt SECONDS] [--les]
        [--forcing {bomex,dycoms,convective_bl,stable_bl,
                    stable_bl_custom_sbl,canopy}]
        [--ocean [--problem {homogeneous,gyre}]]
        [--split-explicit [--variant {new,split01,split01_3n}]]

Builds a ``chip_smoke.py`` path (dry Held-Suarez p4 with DryBiharmonic(8
h) hyperdiffusion, n_horz=16, n_vert=8, float32, with the every-step
filter): the explicit LSRK54 step (``ExplicitSolverType().make``), or
with ``--imex`` the IMEX step (``IMEXSolverType().make``, ARK2GKC with
the block-tridiagonal column solver, dt from the horizontal acoustic
CFL); ``--no-hyperdiffusion`` drops the chain; ``--surface-kernel`` sets
the RHS's surface pass (``VarMajorRHS.surface_kernel``, "xla" by
default).  ``--grid`` takes the generic DG operator as the RHS
(``state_layout="grid"``), ``--dense`` the IMEX step with the dense
column solver on the fused remainder.  ``--moist`` builds the moist
baroclinic wave instead (EquilMoist, EquilMoistBiharmonic(8 h), no
filter, at the same width), with a ``saturation`` span inside
``thermo``; ``--dt`` overrides the step's dt (the moist IMEX step is
stable only below the dry one's: chip_smoke.py's moist_imex_dt_scan
finds the dt).  ``--les`` builds the rising-bubble LES instead
(experiments/risingbubble.py: SmagorinskyLilly(0.21), the 2500 m cube at
Δ = 25 m, p4, 15,625 elements, float32) through
``AtmosLESConfiguration`` and ``make_solver_configuration`` (dt at
Courant 0.4), whose explicit step runs on the generic DG operator with
its gradient pass; its spans are ``gradient`` (the DG gradient),
``gradient_flux``, ``volume`` (the volume tendency with F₂),
``surface`` (the face pass) with ``second_order_faces`` (F₂* on both
sides) inside it, and ``sources``.  ``--forcing`` builds a forced LES
case of experiments/forced_les.py at its example's defaults instead
(float64, the example's Courant number and solver), with the bubble's spans and
``saturation`` (the saturation adjustment, with EquilMoist),
``stack_integrals`` (DYCOMS's radiation paths) and ``tmar`` (BOMEX's
TMAR after each step).  ``--ocean`` builds the ocean box
GCM (experiments/ocean_box.py at its defaults: HomogeneousBox, or
OceanGyre with ``--problem gyre``, 20 × 20 × 20 elements at p4, float64,
LSRK144 at dt = 55 s), whose spans are ``pre_stage`` (the vertical
filters before each stage), ``gradient``, ``gradient_flux``,
``stack_integrals`` (w, pkin and wz0), ``volume``, ``surface`` with
``second_order_faces`` inside it, and ``sources``.  ``--split-explicit``
builds the split-explicit gyre (experiments/ocean_split_explicit.py at
its defaults: 20 × 20 × 20 elements at p4 and the 20 × 20 barotropic
brick, float64, LSRK54 slow at 5400 s and fast at 240 s, 5 IVDC solves
a slow step), whose step is a slow step and its IVDC solves; its spans
are ``slow_rhs`` (the 3-D RHS after its filters), ``transfer`` (Gᵁ and
ΔGᵘ), ``fast`` (a stage's fast steps), ``reconcile`` (Δu and η down the
columns) and ``ivdc`` with ``gmres`` inside it (these two the solver's
and ocean/ivdc.py's own); ``--variant split01`` or ``split01_3n`` takes
the Julia simple_box configuration of that variant instead
(``ocean_split_explicit.make_julia``), whose stages run ``fast_window``
(the averaging window's fast steps) and ``reconcile_split01``.  It warms up, times ``--steps``
steps with tracing off, then traces the same number of steps with
``torch.profiler``.  The RHS's parts (the surface kernels' stages as
``extract`` and ``lift`` inside ``surface``), and on the IMEX step the
column solve, the operator application and the two layout conversions,
are wrapped in ``record_function`` spans from here, around the calls
into each layer, so the program itself carries no instrumentation.  On
the generic operator the spans are its chain, volume kernel, surface
pass and sources; the rest of its call (aux refresh, F₂ and its
contraction, F₂'s interface term) is outside them.

Prints one JSON line: ms/step untraced and traced, the card's busy time
(union of kernel intervals) and idle share of the traced window, kernels
launched per step, per span its host time and the length of its range
on the device timeline, and the kernels with the most device time; with
``--moist`` also the saturation adjustment alone, traced over three
calls on the last state: its kernels and busy time a call, and its share
of the step's busy time.  Writes the
Chrome trace to ``DIR/profile_step_trace.json`` (default profile_out/).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from collections import defaultdict
from types import SimpleNamespace

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from climatemachine_tpu_torch.dg.fast_rhs import SURFACE_KERNELS
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.driver.driver import init as driver_init
from climatemachine_tpu_torch.driver.solver_configs import \
    make_solver_configuration
from climatemachine_tpu_torch.driver.solver_types import (ExplicitSolverType,
                                                          IMEXSolverType)
from climatemachine_tpu_torch.experiments.baroclinic_wave import \
    baroclinic_wave_config
from climatemachine_tpu_torch.experiments.ocean_box import (PROBLEMS,
                                                             ocean_box_config)
from climatemachine_tpu_torch.experiments import ocean_split_explicit
from climatemachine_tpu_torch.experiments.forced_les import CASES
from climatemachine_tpu_torch.experiments.held_suarez import (
    HeldSuarezStepFilter, held_suarez_config)
from climatemachine_tpu_torch.experiments.risingbubble import \
    risingbubble_config
from climatemachine_tpu_torch.mesh.grid import min_node_distance
from climatemachine_tpu_torch.physics import thermodynamics as td

SPANS = ("thermo", "saturation", "chain", "volume", "surface", "extract",
         "lift", "sources", "filter", "solve", "apply", "to_blocks",
         "from_blocks", "gradient", "gradient_flux", "second_order_faces",
         "pre_stage", "stack_integrals", "slow_rhs", "transfer", "fast",
         "reconcile", "ivdc", "gmres", "tmar")


def _span(name, fn):
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def _busy_us(kernels):
    """The union of the kernels' intervals on the device timeline, µs."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        if cur_e is not None and s <= cur_e:
            cur_e = max(cur_e, e)
            continue
        busy += 0.0 if cur_e is None else cur_e - cur_s
        cur_s, cur_e = s, e
    return busy + (0.0 if cur_e is None else cur_e - cur_s)


def _saturation_alone(rhs, q, aux, calls=3):
    """The saturation adjustment of ``rhs``'s thermo at state q and aux,
    traced alone over ``calls`` calls: (kernels, busy ms) a call."""
    rho, ru = q[:, 0], q[:, 1:4]
    e_int = ((q[:, 4] - 0.5 * torch.sum(ru * ru, dim=1) / rho) / rho
             - aux[:, rhs.i_phi])
    args = (rhs.bl.param_set, e_int, rho, q[:, 5] / rho)
    td.saturation_adjustment(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            td.saturation_adjustment(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(kernels) / calls, _busy_us(kernels) / 1e3 / calls


class SplitExplicitStep:
    """A slow split-explicit step and its IVDC solves, as ``step(q, aux,
    t)`` over the state pairs, with the spans of the module docstring."""

    def __init__(self, cfg):
        self.cfg, se = cfg, cfg.solver
        for name in ("slow_rhs", "transfer", "fast", "fast_window",
                     "reconcile", "reconcile_split01"):
            setattr(se, "_" + name, _span(name, getattr(se, "_" + name)))

    def step(self, q, aux, t):
        q, aux, *_ = ocean_split_explicit.step(self.cfg, q, aux, t)
        return q, aux


def _instrument(args, cfg, dg, q, aux, dt, solver, sc):
    """(solver, rhs) of the Held-Suarez, moist, LES or ocean-box step with
    its spans."""
    layout = "grid" if args.grid else "auto"
    les = args.les or args.forcing
    if args.moist or args.forcing:
        td.saturation_adjustment = _span("saturation",
                                         td.saturation_adjustment)
    if args.dense:
        solver = IMEXSolverType(columnwise_solver="dense").make(dg, q, aux,
                                                                dt)
        rhs, sv = solver.rhs_ex, solver.solver
        sv.solve = _span("solve", sv.solve)
        sv.apply_op = _span("apply", sv.apply_op)
    elif args.imex:
        solver = IMEXSolverType(state_layout=layout).make(dg, q, aux, dt)
        rhs, sv = solver.rhs_full, solver.solver
        sv.solve_blocks = _span("solve", sv.solve_blocks)
        sv.apply_op_blocks = _span("apply", sv.apply_op_blocks)
        sv.layout.to_blocks = _span("to_blocks", sv.layout.to_blocks)
        sv.layout.from_blocks = _span("from_blocks", sv.layout.from_blocks)
    elif les:
        solver = sc.solver
        solver.dt = dt
        rhs = solver.rhs
        rad = rhs.balance_law.physics.radiation
        if rad is not None:
            rad.update_aux_integrals = _span("stack_integrals",
                                             rad.update_aux_integrals)
    elif args.ocean:
        rhs = solver.rhs
        solver.pre_stage = _span("pre_stage", solver.pre_stage)
    else:
        solver = ExplicitSolverType(state_layout=layout).make(dg, q, aux, dt)
        rhs = solver.rhs
    if not (args.moist or les or args.ocean):
        solver.post_step = _span("filter", HeldSuarezStepFilter(
            cfg.grid, cfg.model).apply_vm)
    if les or args.ocean:
        rhs.spatial_gradient = _span("gradient", rhs.spatial_gradient)
        bl = rhs.balance_law
        if args.ocean:
            bl.update_auxiliary_state_gradient = _span(
                "stack_integrals", bl.update_auxiliary_state_gradient)
        bl.compute_gradient_flux = _span("gradient_flux",
                                         bl.compute_gradient_flux)
        rhs.volume_tendency = _span("volume", rhs.volume_tendency)
        rhs.surface = _span("surface", rhs.surface)
        rhs.nf2 = _span("second_order_faces", rhs.nf2)
        bl.source = _span("sources", bl.source)
    elif isinstance(rhs, DGModel):
        rhs.hyperdiffusive_state = _span("chain", rhs.hyperdiffusive_state)
        rhs.volume = _span("volume", rhs.volume)
        rhs.surface = _span("surface", rhs.surface)
        rhs.balance_law.source = _span("sources", rhs.balance_law.source)
    else:
        rhs.surface_kernel = args.surface_kernel
        rhs.surface_stages = tuple(
            _span(name, stage) for name, stage in
            zip(("extract", "lift"), rhs.surface_stages))
        rhs._thermo_update = _span("thermo", rhs._thermo_update)
        rhs._chain = _span("chain", rhs._chain)
        rhs.volume = _span("volume", rhs.volume)
        rhs._surface = _span("surface", rhs._surface)
        rhs._sources = _span("sources", rhs._sources)
    return solver, rhs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--no-hyperdiffusion", action="store_true")
    ap.add_argument("--imex", action="store_true")
    ap.add_argument("--surface-kernel", choices=SURFACE_KERNELS,
                    default="xla")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--moist", action="store_true")
    ap.add_argument("--dt", type=float, default=None)
    ap.add_argument("--les", action="store_true")
    ap.add_argument("--forcing", default=None, choices=tuple(CASES))
    ap.add_argument("--ocean", action="store_true")
    ap.add_argument("--problem", choices=PROBLEMS, default="homogeneous")
    ap.add_argument("--split-explicit", action="store_true")
    ap.add_argument("--variant", default="new",
                    choices=("new",) + tuple(ocean_split_explicit.JULIA))
    args = ap.parse_args(argv)
    args.imex |= args.dense
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    tau = None if args.no_hyperdiffusion else 8 * 3600.0
    cfg = sc = solver = None
    if args.split_explicit:
        cfg = (ocean_split_explicit.make(device="cuda")
               if args.variant == "new" else ocean_split_explicit.make_julia(
                   args.variant, device="cuda"))
        dg, q, aux, dt = cfg.dg3, cfg.q, cfg.aux, cfg.solver.dt
        solver, rhs, tau = SplitExplicitStep(cfg), cfg.dg3, None
    elif args.ocean:
        dg, q, aux, solver = ocean_box_config(args.problem, device="cuda")
        dt = solver.dt = args.dt or solver.dt
        tau = None
    elif args.les or args.forcing:
        driver_init(show_updates="never")
        case = CASES[args.forcing] if args.forcing else None
        cfg = (case.config(device="cuda") if case
               else risingbubble_config(device="cuda"))
        sc = make_solver_configuration(
            0.0, -1.0, cfg, ode_solver_type=case.solver_type if case else None,
            Courant_number=case.courant if case else 0.4)
        dg, q, aux, dt = sc.dg, sc.q, sc.aux, args.dt or sc.dt
        tau = None
    else:
        config = (baroclinic_wave_config if args.moist
                  else held_suarez_config)
        cfg = config(16, 8, 4, dtype=torch.float32, device="cuda",
                     hyperdiffusion_tau=tau)
        dg = DGModel(cfg.model, cfg.grid)
        q, aux = init_ode_state(dg)
        dt = args.dt or (
            0.1 * min_node_distance(cfg.grid, "horizontal") if args.imex
            else 0.3 * min_node_distance(cfg.grid)) / 350.0
    if not args.split_explicit:
        solver, rhs = _instrument(args, cfg, dg, q, aux, dt, solver, sc)

    # a forced case's per-step callbacks (BOMEX's one: TMAR)
    step_fns = ([_span("tmar", cb.fn) for cb in case.callbacks(cfg)]
                if args.forcing else [])

    def run(n, q, aux):
        for i in range(n):
            q, aux = solver.step(q, aux, i * dt)
            for fn in step_fns:
                state = SimpleNamespace(q=q)
                fn(state)
                q = state.q
        torch.cuda.synchronize()
        return q, aux

    q, aux = run(3, q, aux)
    t0 = time.perf_counter()
    q, aux = run(args.steps, q, aux)
    untraced = (time.perf_counter() - t0) / args.steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        q, aux = run(args.steps, q, aux)
        traced = (time.perf_counter() - t0) / args.steps
    assert all(bool(torch.isfinite(x).all())
               for x in (q if isinstance(q, tuple) else (q,)))

    # device-side events are kernels, memcpys and the device ranges of
    # the record_function spans; the spans are counted apart
    events = prof.events()
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in on_dev if e.name not in SPANS]
    busy = _busy_us(kernels)
    window_us = traced * args.steps * 1e6

    def per_step(evs):
        return {"calls_per_step": len(evs) / args.steps,
                "ms_per_step": sum(e.time_range.end - e.time_range.start
                                   for e in evs) / 1e3 / args.steps}

    spans = {name: {"host": per_step([e for e in events if e.name == name
                                      and e.device_type == DeviceType.CPU]),
                    "device_range": per_step([e for e in on_dev
                                              if e.name == name])}
             for name in SPANS}
    by_kernel = defaultdict(list)
    for e in kernels:
        by_kernel[e.name].append(e)
    top = sorted(((name, per_step(evs)) for name, evs in by_kernel.items()),
                 key=lambda kv: -kv[1]["ms_per_step"])[:12]

    saturation = {}
    if args.moist:
        n_kernels, busy_ms = _saturation_alone(rhs, q, aux)
        calls = spans["saturation"]["host"]["calls_per_step"]
        saturation = {"saturation_alone": {
            "calls_per_step": calls, "kernels_per_call": n_kernels,
            "busy_ms_per_call": busy_ms,
            "share_of_step_busy": calls * busy_ms * 1e3 * args.steps / busy}}

    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out,
                                          "profile_step_trace.json"))
    print(json.dumps({
        "card": power, "steps": args.steps,
        "model": (f"split-explicit ocean gyre ({args.variant})"
                  if args.split_explicit
                  else f"ocean box GCM ({args.problem})" if args.ocean
                  else f"forced LES ({args.forcing})" if args.forcing
                  else "rising bubble LES (SmagorinskyLilly)" if args.les
                  else "moist baroclinic wave" if args.moist
                  else "Held-Suarez"),
        "step": ("dense imex" if args.dense else "imex" if args.imex
                 else "split-explicit with IVDC" if args.split_explicit
                 else "explicit"), "dt_s": dt,
        "rhs": type(rhs).__name__,
        "surface_kernel": (args.surface_kernel if not isinstance(rhs, DGModel)
                           else rhs.surface_kernel),
        "hyperdiffusion_tau": tau,
        "elements": dg.grid.nelem,
        "ms_per_step_untraced": 1e3 * untraced,
        "ms_per_step_traced": 1e3 * traced,
        "device_busy_ms_per_step": busy / 1e3 / args.steps,
        "device_idle_share": 1.0 - busy / window_us,
        "kernels_per_step": len(kernels) / args.steps,
        "spans": spans,
        "top_kernels": [{"name": name[:80], **t} for name, t in top],
        **saturation}),
        flush=True)


if __name__ == "__main__":
    main()
