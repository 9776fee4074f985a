"""float32 against float64 on the CPU for three steps of the moist
baroclinic wave on a small grid, in the JAX package and in the port, and
where the moist IMEX step of tests/test_torch_moist_imex.py blows up.
The gaps are the measurement chip_smoke.py's MOIST_SMALL_TOL (LSRK54,
n_horz=2, n_vert=2, p4, dt = 0.3 · node distance / 350 m/s) and
MOIST_IMEX_SMALL_TOL (ARK2GKC through ``IMEXSolverType().make``,
n_horz=2, n_vert=3, p4, dt = 0.01 · horizontal node distance / 350 m/s)
are set from (10× the larger gap).
Both runs of a package start from the same float32 geometry and initial
state (upcast for float64), so they differ by arithmetic precision only.

    python tests/moist_precision_gap.py

prints one JSON line per solver with both packages' per-variable gaps
(max|q32 − q64| over elements and nodes, relative to max|q64| of that
variable), then, for each package and CFL of BLOWUP_CFLS, the first of
six float64 IMEX steps from the initial state at n_horz=2, n_vert=4, p3
whose state is not finite or has max|u| >= 150 m/s (null if none).  It
takes about four minutes on a CPU, most of it the JAX package's
compilation; tests/test_torch_moist_rhs.py runs the port's gaps.
"""

import json

import numpy as np
import torch

#: solver -> (n_vert, CFL, direction of the node distance)
CASES = {"LSRK54": (2, 0.3, "every"), "IMEX": (3, 0.01, "horizontal")}
#: horizontal CFLs of the IMEX blow-up check: the dry tests', a fifth of
#: it, and tests/test_torch_moist_imex.py's
BLOWUP_CFLS = (0.1, 0.02, 0.01)


def _first_bad(states):
    """The 1-based index of the first var-major state that is not finite
    or has max|u| >= 150 m/s, else None."""
    for i, q in enumerate(states):
        q = np.asarray(q, np.float64)
        if not (np.isfinite(q).all()
                and np.abs(q[:, 1:4] / q[:, :1]).max() < 150.0):
            return i + 1
    return None


def port_blowup(cfl: float, steps: int = 6):
    from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
    from climatemachine_tpu_torch.driver.solver_types import IMEXSolverType
    from climatemachine_tpu_torch.experiments.baroclinic_wave import \
        baroclinic_wave_config
    from climatemachine_tpu_torch.mesh.grid import min_node_distance
    cfg = baroclinic_wave_config(2, 4, 3, dtype=torch.float64, device="cpu")
    dg = DGModel(cfg.model, cfg.grid)
    q, aux = init_ode_state(dg)
    dt = cfl * min_node_distance(cfg.grid, "horizontal") / 350.0
    s = IMEXSolverType().make(dg, q, aux, dt)
    states = []
    for i in range(steps):
        q, aux = s.step(q, aux, i * dt)
        states.append(q.numpy())
    return _first_bad(states)


def _jax():
    """JAX on the CPU with float64 enabled."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def jax_blowup(cfl: float, steps: int = 6):
    _jax()
    from climatemachine_tpu.dg.spatial import DGModel, init_ode_state
    from climatemachine_tpu.driver.solver_types import IMEXSolverType
    from climatemachine_tpu.experiments.baroclinic_wave import \
        baroclinic_wave_config
    from climatemachine_tpu.mesh.grid import min_node_distance
    cfg = baroclinic_wave_config(2, 4, 3, dtype=np.float64)
    dg = DGModel(cfg.model, cfg.grid)
    q, aux = init_ode_state(dg)
    dt = cfl * float(min_node_distance(cfg.grid, "horizontal")) / 350.0
    s = IMEXSolverType().make(dg, q, aux, dt)
    qv, av = s.vm.to_vm(q), s.vm.aux_to_vm(aux)
    states = []
    for i in range(steps):
        qv, av = s.step(qv, av, i * dt)
        states.append(np.asarray(qv))
    return _first_bad(states)


def _gap(q32, q64):
    q32, q64 = np.asarray(q32, np.float64), np.asarray(q64, np.float64)
    return (np.abs(q32 - q64).max(axis=(0, 2))
            / np.abs(q64).max(axis=(0, 2))).tolist()


def port_gap(solver: str) -> list:
    """The port's gap (its float32 and float64 runs on the CPU)."""
    from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
    from climatemachine_tpu_torch.driver.solver_types import (
        ExplicitSolverType, IMEXSolverType)
    from climatemachine_tpu_torch.experiments.baroclinic_wave import \
        baroclinic_wave_config
    from climatemachine_tpu_torch.interop import (grid_from_numpy,
                                                  grid_to_numpy)
    from climatemachine_tpu_torch.mesh.grid import min_node_distance
    n_vert, cfl, direction = CASES[solver]
    cfg = baroclinic_wave_config(2, n_vert, 4, dtype=torch.float32,
                                 device="cpu")
    g = cfg.grid
    g64 = grid_from_numpy(grid_to_numpy(g), device="cpu",
                          dtype=torch.float64)
    q, aux = init_ode_state(DGModel(cfg.model, g))
    dt = cfl * min_node_distance(g, direction) / 350.0
    kind = IMEXSolverType() if solver == "IMEX" else ExplicitSolverType()
    out = {}
    for name, (grid, qq, aa) in {"f32": (g, q, aux),
                                 "f64": (g64, q.double(), aux.double())
                                 }.items():
        s = kind.make(DGModel(cfg.model, grid), qq, aa, dt)
        for i in range(3):
            qq, aa = s.step(qq, aa, i * dt)
        out[name] = qq.numpy()
    return _gap(out["f32"], out["f64"])


def jax_gap(solver: str) -> list:
    """The JAX package's gap, var-major steps through its solver types
    (the explicit step's RHS jitted)."""
    jax = _jax()
    import jax.numpy as jnp

    from climatemachine_tpu.dg.spatial import DGModel, init_ode_state
    from climatemachine_tpu.driver.solver_types import (ExplicitSolverType,
                                                        IMEXSolverType)
    from climatemachine_tpu.experiments.baroclinic_wave import \
        baroclinic_wave_config
    from climatemachine_tpu.mesh.grid import min_node_distance
    from climatemachine_tpu.ode.lsrk import LSRK54CarpenterKennedy
    n_vert, cfl, direction = CASES[solver]
    cfg32 = baroclinic_wave_config(2, n_vert, 4, dtype=np.float32)
    q32, aux32 = init_ode_state(DGModel(cfg32.model, cfg32.grid))
    dt = cfl * float(min_node_distance(cfg32.grid, direction)) / 350.0
    cfg64 = baroclinic_wave_config(2, n_vert, 4, dtype=np.float64)
    out = {}
    for name, (cfg, q, aux) in {
            "f32": (cfg32, q32, aux32),
            "f64": (cfg64, jnp.asarray(q32, jnp.float64),
                    jnp.asarray(aux32, jnp.float64))}.items():
        dg = DGModel(cfg.model, cfg.grid)
        kind = IMEXSolverType() if solver == "IMEX" else ExplicitSolverType()
        s = kind.make(dg, q, aux, dt)
        vm = s.vm
        if solver == "LSRK54":
            s = LSRK54CarpenterKennedy(jax.jit(vm), dt)
        qv, av = vm.to_vm(q), vm.aux_to_vm(aux)
        for i in range(3):
            qv, av = s.step(qv, av, i * dt)
        out[name] = np.asarray(qv)
    return _gap(out["f32"], out["f64"])


if __name__ == "__main__":
    for solver in CASES:
        print(json.dumps({"solver": solver, "port": port_gap(solver),
                          "jax": jax_gap(solver)}), flush=True)
    for cfl in BLOWUP_CFLS:
        print(json.dumps({"imex_blowup_cfl": cfl, "port": port_blowup(cfl),
                          "jax": jax_blowup(cfl)}), flush=True)
