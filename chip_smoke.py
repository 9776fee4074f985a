"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels from csrc/, holds each against its plain PyTorch
version at the shapes the main path gives it, then drives the main path
through its public entry points: dry Held-Suarez p4 on a stacked cubed
sphere at n_horz=16, n_vert=8 (12,288 elements, 1.536 M nodes), float32,
LSRK54 with the every-step exponential filter.  One JSON line per phase;
then the card's name and power limit as nvidia-smi reports them, a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero without the last line.  Without a
CUDA device it exits 1 at once.

Tolerances:
- kernel vs plain, same inputs: max|Δ| <= 1e-5 · max|plain| — float32
  sums of 375 products in another order (the float32 precedent of
  tests/test_pallas_volume.py);
- one LSRK54 step with the kernel vs one with the plain version, from
  the same state: per variable, max|Δq| <= 1e-3 · max|q1 − q0|
  + 4 · eps32 · max|q1| — the step's increment carries the kernel's
  1e-5, and where the two increments differ in their last bits the
  float32 updates q + dt·dq round a few ulp apart;
- three steps of a small grid (n_horz=2, n_vert=2, p4) in float32 on the
  card vs float64 on the CPU (the plain path the CPU tests hold against
  the JAX package) from the same float32 geometry and state: per
  variable, max|Δq| <= 1e-4 · max|q| — float32 round-off of the
  cancellations p − p_ref and ρe/ρ − Φ, amplified by the spectral
  derivative (1.1e-5 for ρu in float32 on a CPU);
- mass Σ M ρ, summed in float64: relative drift <= 1e-5 over the run
  (float32 round-off; the filter keeps each element's mode 0 but is not
  exactly conservative on curved elements).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from climatemachine_tpu_torch import resolve_device
from climatemachine_tpu_torch.dg import volume_kernel
from climatemachine_tpu_torch.dg.fast_rhs import VarMajorRHS
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.experiments.held_suarez import (
    HeldSuarezStepFilter, held_suarez_config)
from climatemachine_tpu_torch.interop import (FLOAT_FIELDS, INDEX_FIELDS,
                                              grid_from_numpy)
from climatemachine_tpu_torch.mesh.grid import min_node_distance
from climatemachine_tpu_torch.ode.lsrk import LSRK54CarpenterKennedy

N_HORZ, N_VERT, POLY = 16, 8, 4
N_WARM, N_STEPS = 3, 20
PEAK_FP32_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
KERNEL_TOL = 1e-5
STEP_TOL = 1e-3
SMALL_TOL = 1e-4
MASS_TOL = 1e-5


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what):
    """A failed check ends the run (unlike assert, also under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int, warm: int = 3) -> float:
    """Mean device time of ``fn`` in ms over n calls (CUDA events)."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def volume_cost(E: int, Np: int):
    """(bytes, flops) the fused volume tendency needs: each input read
    once, the output written once; per node 2·5·3Np for the contraction,
    111 for flux, metric and mass, 5 for the MI scaling."""
    nbytes = 4 * (E * Np * (5 + 1 + 1 + 9 + 1 + 1 + 5) + Np * 3 * Np)
    flops = E * Np * (2 * 5 * 3 * Np + 111 + 5)
    return nbytes, flops


def phase_device():
    dev = resolve_device(None)
    check(dev.type == "cuda", dev)
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul on")
    check(torch.backends.cudnn.allow_tf32 is False, "TF32 cuDNN on")
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=nvidia_smi(),
         torch=torch.__version__, cuda=torch.version.cuda,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32)


def phase_build():
    info = volume_kernel.build()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", kernel="volume_vm", built=info["built"],
         seconds=info["seconds"], ptxas=ptxas)


def kernel_inputs(rhs, seed: int):
    """Physically scaled random state on the main path's geometry:
    ρ ≈ 1, |u| <= 50 m/s, p ≈ 1e5 Pa, p_ref within 0.1 % of p."""
    g = rhs.grid
    E, Np = g.nelem, g.Np
    gen = torch.Generator(device=g.device).manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=gen, device=g.device)
    rand = lambda *s: torch.rand(s, generator=gen, device=g.device)
    rho = 1.0 + 0.1 * randn(E, Np)
    u = 50.0 * (2 * rand(E, 3, Np) - 1)
    rhoe = rho * (2.5e5 + 1e4 * randn(E, Np))
    qv = torch.cat([rho[:, None], rho[:, None] * u, rhoe[:, None]], 1)
    p = 1e5 * (1 + 0.05 * randn(E, Np))
    p_ref = p * (1 + 1e-3 * randn(E, Np))
    phi = torch.zeros_like(p)
    return (qv.contiguous(), p, phi, p_ref, None, None, None, rhs.xiv,
            g.M, g.MI, g.Wdiv)


def phase_kernel(rhs, seed: int) -> dict:
    ps = rhs.bl.param_set
    args = kernel_inputs(rhs, seed)
    kw = dict(nq=5, ngl=1, R_d=ps.R_d, cv_d=ps.cv_d, T_0=ps.T_0,
              subtract_ref=True)
    out = volume_kernel.fused_volume_tendency_vm(*args, **kw)
    ref = volume_kernel.volume_tendency_plain(*args, **kw)
    torch.cuda.synchronize()
    diff = (out - ref).abs().amax(dim=(0, 2))
    scale = ref.abs().max().item()
    max_err = diff.max().item()
    ms = cuda_ms(lambda: volume_kernel.fused_volume_tendency_vm(*args, **kw),
                 50)
    plain_ms = cuda_ms(lambda: volume_kernel.volume_tendency_plain(*args,
                                                                   **kw), 10)
    g = rhs.grid
    E, Np = g.nelem, g.Np
    mf = torch.randn((E * 5, 3 * Np), device=g.device)
    wT = g.Wdiv.T.contiguous()
    matmul_ms = cuda_ms(lambda: torch.matmul(mf, wT), 50)
    nbytes, flops = volume_cost(E, Np)
    t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_FP32_FLOPS
    res = dict(max_abs_err=max_err, max_abs_plain=scale,
               max_abs_err_per_var=diff.tolist(), tol=KERNEL_TOL,
               ms=ms, plain_ms=plain_ms, contraction_matmul_ms=matmul_ms,
               bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes > t_ops else "operations",
               E=E, Np=Np)
    emit("kernel_vs_plain", name="fused_volume_tendency_vm", **res)
    check(bool(torch.isfinite(out).all()), "kernel output not finite")
    check(max_err <= KERNEL_TOL * scale, ("kernel vs plain", max_err, scale))
    return res


def small_reference_check():
    """A few float32 steps of a small grid on the card against float64
    steps on the CPU from the same float32 geometry and initial state
    (upcast), so the two differ by arithmetic precision only."""
    cfg = held_suarez_config(2, 2, POLY, dtype=torch.float32,
                             hyperdiffusion_tau=None, device="cuda")
    g = cfg.grid
    fields = {k: getattr(g, k).cpu().numpy()
              for k in FLOAT_FIELDS + INDEX_FIELDS}
    fields.update(xi=g.xi, face_perm_identity=g.face_perm_identity)
    grid64 = grid_from_numpy(fields, device="cpu", dtype=torch.float64)
    q, aux = init_ode_state(DGModel(cfg.model, g))
    runs = {"card_f32": (g, q, aux),
            "cpu_f64": (grid64, q.double().cpu(), aux.double().cpu())}
    dt = 0.3 * min_node_distance(g) / 350.0
    final = {}
    for name, (grid, q, aux) in runs.items():
        sol = LSRK54CarpenterKennedy(
            VarMajorRHS(DGModel(cfg.model, grid), write_aux=False), dt,
            post_step=HeldSuarezStepFilter(grid, cfg.model).apply_vm)
        for i in range(3):
            q, aux = sol.step(q, aux, i * dt)
        final[name] = q.double().cpu()
    ref = final["cpu_f64"]
    err = ((final["card_f32"] - ref).abs().amax(dim=(0, 2))
           / ref.abs().amax(dim=(0, 2))).tolist()
    emit("small_reference", n_horz=2, n_vert=2, poly=POLY, steps=3,
         rel_err_per_var=err, tol=SMALL_TOL)
    check(max(err) <= SMALL_TOL, ("small reference", err))


def phase_main_path(seed: int) -> dict:
    t0 = time.perf_counter()
    cfg = held_suarez_config(n_horz=N_HORZ, n_vert=N_VERT, poly_order=POLY,
                             dtype=torch.float32, hyperdiffusion_tau=None,
                             device="cuda")
    dg = DGModel(cfg.model, cfg.grid)
    q0, aux0 = init_ode_state(dg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    g = cfg.grid
    E, Np = g.nelem, g.Np
    dt = 0.3 * min_node_distance(g) / 350.0
    hsf = HeldSuarezStepFilter(g, cfg.model)
    rhs = VarMajorRHS(dg, write_aux=False)
    solver = LSRK54CarpenterKennedy(rhs, dt, post_step=hsf.apply_vm)

    kernel = phase_kernel(rhs, seed)

    # one step with the kernel against one with the plain version
    plain = LSRK54CarpenterKennedy(
        VarMajorRHS(dg, write_aux=False,
                    volume=volume_kernel.volume_tendency_plain),
        dt, post_step=hsf.apply_vm)
    q1, _ = solver.step(q0, aux0, 0.0)
    q1p, _ = plain.step(q0, aux0, 0.0)
    eps32 = torch.finfo(torch.float32).eps
    bound = (STEP_TOL * (q1p - q0).abs().amax(dim=(0, 2))
             + 4 * eps32 * q1p.abs().amax(dim=(0, 2)))
    step_err = ((q1 - q1p).abs().amax(dim=(0, 2)) / bound).tolist()
    emit("step_vs_plain", err_over_bound_per_var=step_err, tol=STEP_TOL)
    check(max(step_err) <= 1.0, ("step vs plain", step_err))

    small_reference_check()

    # the main path: counts from 0, warm-up plus timed steps
    mass = lambda q: torch.sum(g.M.double() * q[:, 0].double()).item()
    m0 = mass(q0)
    volume_kernel.fused_volume_tendency_vm.launches = 0
    q, aux, t = q0, aux0, 0.0
    for _ in range(N_WARM):
        q, aux = solver.step(q, aux, t)
        t += dt
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(N_STEPS):
        q, aux = solver.step(q, aux, t)
        t += dt
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = volume_kernel.fused_volume_tendency_vm.launches
    aux = rhs.export_aux(q, aux)
    drift = abs(mass(q) - m0) / m0
    finite = bool(torch.isfinite(q).all() and torch.isfinite(aux).all())
    res = dict(card=nvidia_smi(), n_horz=N_HORZ, n_vert=N_VERT, poly=POLY,
               elements=E, gridpoints=E * Np, dtype="float32", dt_s=dt,
               warm_steps=N_WARM, steps=N_STEPS, setup_s=setup_s,
               ms_per_step=1e3 * wall / N_STEPS,
               gridpoints_per_s=E * Np * N_STEPS / wall,
               volume_launches=launches,
               expected_launches=5 * (N_WARM + N_STEPS),
               mass_drift_rel=drift, mass_tol=MASS_TOL, finite=finite,
               shape=list(q.shape))
    emit("main_path", **res)
    check(list(q.shape) == [E, 5, Np], ("state shape", list(q.shape)))
    check(finite, "state not finite")
    check(launches == 5 * (N_WARM + N_STEPS), ("volume launches", launches))
    check(drift <= MASS_TOL, ("mass drift", drift))
    return dict(kernel=kernel, launches=launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    phase_device()
    phase_build()
    res = phase_main_path(args.seed)
    k = res["kernel"]
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_volume_tendency_vm", "route": "cuda",
        "source": "climatemachine_tpu_torch/csrc/volume_vm.cu",
        "replaces": "climatemachine_tpu/dg/pallas_volume.py:264",
        "launches": res["launches"], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
