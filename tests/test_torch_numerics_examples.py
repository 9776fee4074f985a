"""The port's two examples of the numerics slice against the JAX
package's examples (examples/rising_bubble_bryan.py,
examples/timestepping_compare.py), in float64 on the CPU at a small
size.  Each JAX example's ``main`` runs with its command line set to the
small size and its ``invoke`` / ``solve`` replaced by a recorder, which
yields the example's own configuration, initial state and solvers
without integrating:

- the Bryan bubble at 1000 m (5 × 1 × 2 elements): the initial state and
  aux within 1e-12, dt equal, and one step of ``MISSolverType`` (MIS2 with
  LSRK54, and with SSPRK33ShuOsher: the menu's "lsrk" and "ssprk") from
  the initial state within 1e-10 of each variable's max|q|; the port's
  ``run`` to 2 s stays finite and reports its max updraft (the errors
  are relative to each variable's max, that of ρu over its three
  components: one element deep in y, ρv is round-off);
- the time-integrator comparison at 500 m (1 × 1 × 6 elements): the
  initial state within 1e-12, dt_acoustic equal, the menu's dts equal,
  one step of the SSPRK33 and MIS2 entries within 1e-10 of each
  variable's max; the port's menu to 0.5 s keeps every error below 0.5
  of the control's range, the example's assertion.

The JAX steps run eagerly around their DG operators, each compiled once.
"""

import importlib.util
import pathlib
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from climatemachine_tpu.driver.solver_types import \
    MISSolverType as JaxMISSolverType
from climatemachine_tpu.ode.mis import MIS2 as JaxMIS2
from climatemachine_tpu.ode.ssprk import SSPRK33ShuOsher as JaxSSPRK33
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.driver import driver
from climatemachine_tpu_torch.driver.solver_configs import \
    make_solver_configuration
from climatemachine_tpu_torch.experiments import (rising_bubble_bryan,
                                                  timestepping_compare)
from climatemachine_tpu_torch.interop import to_var_major
from climatemachine_tpu_torch.mesh.grid import min_node_distance
from numerics_parity import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
BRYAN_RESOLUTION = 1000.0
COMPARE_RESOLUTION = 500.0
TOL = 1e-10


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel_per_var(got, ref_node_major):
    """max |got − ref| of ρ, ρu (each component), ρe over the max |ref|
    of ρ, of ρu (all three components: the boxes are one element deep
    in y, where ρv is round-off) and of ρe."""
    ref = to_var_major(np.asarray(ref_node_major), "cpu").numpy()
    got = np.asarray(got)
    peak = np.abs(ref).max(axis=(0, 2))
    peak[1:4] = peak[1:4].max()
    return np.abs(got - ref).max(axis=(0, 2)) / np.maximum(peak, 1e-300)


_COMPILED = {}


def _jax_mis(sol, key):
    """The JAX MIS solver with its slow and fast operators compiled, once
    for each configuration ``key`` (the menus build the same split)."""
    if key not in _COMPILED:
        _COMPILED[key] = (jax.jit(sol.slow_rhs), jax.jit(sol.fast_rhs))
    sol.slow_rhs, sol.fast_rhs = _COMPILED[key]
    return sol


@pytest.fixture(scope="module")
def bryan(monkeypatch_module):
    """The JAX example's configuration with "lsrk"; its "ssprk" solver is
    the example's menu entry made on the same configuration (a second
    ``main`` would build it again)."""
    mod = _load("rising_bubble_bryan")
    seen = {}
    monkeypatch_module.setattr(mod.cm, "invoke",
                               lambda sc: seen.setdefault("sc", sc))
    monkeypatch_module.setattr(sys, "argv", [
        "rising_bubble_bryan.py", "--fast-method", "lsrk", "--resolution",
        str(BRYAN_RESOLUTION), "--timeend", "10", "--platform", "cpu"])
    mod.main()
    sc = seen["sc"]
    ssprk = JaxMISSolverType(mis_method=JaxMIS2, fast_method=JaxSSPRK33,
                             nsubsteps=12).make(sc.dg, sc.q, sc.aux, sc.dt)
    return {"lsrk": sc, "ssprk": SimpleNamespace(
        dg=sc.dg, q=sc.q, aux=sc.aux, dt=sc.dt, solver=ssprk)}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _port_bryan(fm):
    dc = rising_bubble_bryan.bryan_config(BRYAN_RESOLUTION, device="cpu")
    return make_solver_configuration(
        0.0, 10.0, dc, Courant_number=rising_bubble_bryan.COURANT,
        ode_solver_type=rising_bubble_bryan.solver_type(fm))


@pytest.mark.parametrize("fm", ["lsrk", "ssprk"])
def test_bryan_matches_jax(bryan, fm):
    scj = bryan[fm]
    sc = _port_bryan(fm)
    assert sc.dg.grid.nelem == scj.dg.grid.nelem == 10
    assert abs(sc.dt - scj.dt) <= 1e-12 * scj.dt
    assert _rel_per_var(sc.q, scj.q).max() < 1e-12
    assert _rel_per_var(sc.aux, scj.aux).max() < 1e-12
    ref, _ = _jax_mis(scj.solver, "bryan").step(scj.q, scj.aux, 0.0)
    got, _ = sc.solver.step(sc.q, sc.aux, 0.0)
    err = _rel_per_var(got, ref)
    assert err.max() < TOL, err


def test_bryan_run_finite():
    driver.init(show_updates="never")
    sc, w = rising_bubble_bryan.run("ssprk", BRYAN_RESOLUTION, 2.0,
                                    device="cpu")
    assert torch.isfinite(sc.q).all() and 0.0 < w < 5.0
    with pytest.raises(ValueError, match="fast_method"):
        rising_bubble_bryan.solver_type("rk4")


@pytest.fixture(scope="module")
def compare(monkeypatch_module):
    mod = _load("timestepping_compare")
    runs = []

    class Done:
        def __init__(self, q):
            self.q = q

    def recording(q0, aux0, sol, timeend):
        runs.append((q0, aux0, sol))
        return Done(q0)

    class ImexType:
        """In place of the JAX IMEX type, whose ``make`` compiles its
        column probing for ~10 s; its solver is not stepped here."""

        def make(self, dg, q0, aux0, dt):
            return SimpleNamespace(dt=dt)

    monkeypatch_module.setattr(mod, "solve", recording)
    monkeypatch_module.setattr(mod.cm, "IMEXSolverType", ImexType)
    monkeypatch_module.setattr(sys, "argv", [
        "timestepping_compare.py", "--timeend", "1", "--resolution",
        str(COMPARE_RESOLUTION), "--platform", "cpu"])
    mod.main()
    return runs


def test_compare_configuration_matches_jax(compare):
    q0j, aux0j, ctrl = compare[0]
    dc = timestepping_compare.compare_config(COMPARE_RESOLUTION, "cpu")
    q0, aux0 = init_ode_state(DGModel(dc.model, dc.grid))
    assert dc.grid.nelem == q0j.shape[0]
    assert _rel_per_var(q0, q0j).max() < 1e-12
    assert _rel_per_var(aux0, aux0j).max() < 1e-12
    dt_ac = float(min_node_distance(dc.grid)) / 350.0
    cfls = [timestepping_compare.CONTROL_COURANT] + [
        cfl for _, _, cfl in timestepping_compare.MENU]
    assert len(compare) == len(cfls) == 7
    for (_, _, sol), cfl in zip(compare, cfls):
        assert abs(sol.dt - cfl * dt_ac) <= 1e-12 * sol.dt


@pytest.mark.parametrize("entry", [3, 6], ids=["SSPRK33", "MIS2"])
def test_compare_steps_match_jax(compare, entry):
    q0j, aux0j, solj = compare[entry]
    name, solver_type, cfl = timestepping_compare.MENU[entry - 1]
    dc = timestepping_compare.compare_config(COMPARE_RESOLUTION, "cpu")
    dg = timestepping_compare.compare_dg(dc)
    q0, aux0 = init_ode_state(dg)
    sol = solver_type.make(dg, q0, aux0, solj.dt)
    if entry == 3:
        # the JAX explicit type steps the var-major RHS: its step on the
        # JAX generic operator computes the same
        jdg = jax.jit(lambda q, a, t: solj.vm.dg(q, a, t))
        ref, _ = JaxSSPRK33(jdg, solj.dt).step(q0j, aux0j, 0.0)
    else:
        ref, _ = _jax_mis(solj, "compare").step(q0j, aux0j, 0.0)
    got, _ = sol.step(q0, aux0, 0.0)
    err = _rel_per_var(got, ref)
    assert err.max() < TOL, (name, err)


def test_compare_menu_holds_the_example_assertions():
    rows, dt_ac = timestepping_compare.run_menu(0.5, COMPARE_RESOLUTION,
                                                "cpu")
    assert len(rows) == 7 and dt_ac > 0
    timestepping_compare.check(rows[1:])
    assert all(r["finite"] for r in rows)
