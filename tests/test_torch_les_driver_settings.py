"""The port's driver (driver/driver.py, driver/callbacks.py,
driver/configs.py, dg/courant.py, ode/solve.py) against the JAX
package's, in float64 on the CPU, apart from the invoke runs (those are
in tests/test_torch_les_driver.py and its inviscid twin):

- the diffusive Courant number of each closure: ν dt/Δx² of a constant
  viscosity, 0 where the closure's viscosity reads the gradient flux
  (the JAX package's fails on AnisoMinDiss there);
- ``ConservationCheck`` and ``solve`` stop, fire and shorten the last
  step as the JAX package's do, on a solver that drifts the mass;
- ``grid_stretching_1d``, the interval grammar, the settings'
  precedence, the summary log, the refusal of the ``vtk`` and
  ``diagnostics`` interval settings (which the JAX package's ``invoke``
  reads nowhere), ``debug_init``'s dump and ``invoke``'s
  ``diagnostics_config``.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu import driver_api as jcm
from climatemachine_tpu.driver import callbacks as jax_cbs
from climatemachine_tpu.driver import driver as jax_driver
from climatemachine_tpu.ode.solve import solve as jax_solve
from climatemachine_tpu_torch import driver_api as cm
from climatemachine_tpu_torch.dg.courant import diffusive_courant
from climatemachine_tpu_torch.diagnostics.atmos_les import \
    AtmosLESDefaultGroup
from climatemachine_tpu_torch.driver import callbacks as cbs
from climatemachine_tpu_torch.driver import driver
from climatemachine_tpu_torch.io.vtk import readvtk
from les_parity import jax_model, nm, port_model


def test_diffusive_courant():
    """ν dt/Δx² of a constant viscosity; 0 for the closures whose
    viscosity needs the gradient flux."""
    gp = cm.make_grid(cm.topology.stacked_brick_topology(
        [np.linspace(0, 1000.0, 3)] * 3, (True, True, False),
        np.array(((0, 0), (0, 0), (1, 2)))), 2, dtype=torch.float64,
        device="cpu")
    for turb, want in ((cm.ConstantKinematicViscosity(30.0), 30.0 / 4.0),
                       (cm.SmagorinskyLilly(0.21), 0.0)):
        m = port_model(turbulence=turb)
        q, aux = cm.init_ode_state(cm.DGModel(m, gp))
        c = diffusive_courant(m, q, aux, 1.0, 2.0)
        assert c.shape == (gp.nelem, gp.Np)
        assert torch.allclose(c, torch.full_like(c, want), rtol=1e-14)


@pytest.mark.parametrize("closure", ["ConstantKinematicViscosity",
                                     "ConstantDynamicViscosity",
                                     "SmagorinskyLilly", "Vreman",
                                     "AnisoMinDiss"])
def test_diffusive_courant_without_gradient_flux(closure):
    """The closures whose viscosity reads the gradient flux are the
    three ∇u closures, and their diffusive Courant number is 0.  The
    JAX package lists only SmagorinskyLilly and Vreman, and its
    ``diffusive_courant`` fails on AnisoMinDiss, reading a gradient flux
    of None: a difference kept on purpose (ROADMAP queue 3)."""
    from climatemachine_tpu.dg import courant as jax_courant
    args = () if closure.endswith(("Lilly", "Vreman", "Diss")) else (30.0,)
    turb = getattr(cm, closure)(*args)
    needs = closure in ("SmagorinskyLilly", "Vreman", "AnisoMinDiss")
    assert turb.viscosity_needs_gradient_flux == needs
    gp = cm.make_grid(cm.topology.stacked_brick_topology(
        [np.linspace(0, 1000.0, 2)] * 3, (True, True, False),
        np.array(((0, 0), (0, 0), (1, 2)))), 1, dtype=torch.float64,
        device="cpu")
    q, aux = cm.init_ode_state(cm.DGModel(port_model(turbulence=turb), gp))
    c = diffusive_courant(port_model(turbulence=turb), q, aux, 1.0, 2.0)
    assert bool(torch.all(c == 0)) == needs
    jturb = getattr(jcm, closure)(*args)
    jm = jax_model(turbulence=jturb)
    jq = jnp.ones((1, 8, 5))
    if closure == "AnisoMinDiss":
        assert not jax_courant._needs_gf(jturb)
        with pytest.raises(TypeError):
            jax_courant.diffusive_courant(jm, jq, None, 1.0, 2.0)
    else:
        assert jax_courant._needs_gf(jturb) == needs


class _Drift:
    """A solver whose step multiplies the state by 1 + 1e-8 (the mass
    drifts 1e-8 a step)."""
    vm = None

    def __init__(self, dt):
        self.dt = dt

    def step(self, q, aux, t):
        return q * (1 + 1e-8), aux


def _tiny_grid(pkg, grid_kw):
    """A 2 × 2 × 2 LES box at p1."""
    return pkg.make_grid(pkg.topology.stacked_brick_topology(
        [np.linspace(0, 1.0, 3)] * 3, (True, True, False),
        np.array(((0, 0), (0, 0), (1, 2)))), 1, **grid_kw)


@pytest.mark.parametrize("threshold,every", [(3.5e-8, 1), (3.5e-8, 2),
                                             (1e-6, 2)])
def test_conservation_check_and_solve_match_jax(threshold, every):
    """Both packages' ``solve`` with a ConservationCheck on a drifting
    solver, 10 steps of 0.3 s to t = 2.9 s (the last step shortened):
    the step at which the check stops the run (or none), the final time
    and the state."""
    res = {}
    for name, pkg, solve, cb_mod, kw in (
            ("jax", jcm, jax_solve, jax_cbs, dict(dtype=np.float64)),
            ("port", cm, cm.solve, cbs, dict(dtype=torch.float64,
                                             device="cpu"))):
        g = _tiny_grid(pkg, kw)
        model = (jax_model if name == "jax" else port_model)()
        q = np.random.default_rng(1).uniform(1.0, 2.0, (g.nelem, g.Np, 5))
        aux = np.zeros((g.nelem, g.Np, 1))
        if name == "port":
            q, aux = torch.tensor(q).transpose(1, 2), torch.tensor(
                aux).transpose(1, 2)
        else:
            q, aux = jnp.asarray(q), jnp.asarray(aux)
        check = cb_mod.ConservationCheck(g, model, "rho", threshold,
                                         every_steps=every)
        state = solve(q, aux, _Drift(0.3), 2.9, callbacks=[check.make()])
        res[name] = (state.step, state.t, np.asarray(
            state.q if name == "jax" else nm(state.q)))
    assert res["port"][:2] == res["jax"][:2]
    np.testing.assert_allclose(res["port"][2], res["jax"][2], rtol=1e-15)


@pytest.mark.parametrize("spec", ["never", "1000steps", "3.3sdays",
                                  "2shours", "5smins", "7ssecs", "1smonths",
                                  "30mins", "2hours", "60secs"])
def test_interval_grammar_matches_jax(spec):
    assert driver.parse_interval(spec, 1.0) == \
        jax_driver.parse_interval(spec, 1.0)


@pytest.mark.parametrize("stretch", [None, 2.0])
def test_grid_stretching_matches_jax(stretch):
    from climatemachine_tpu.driver.configs import \
        grid_stretching_1d as jax_stretching
    from climatemachine_tpu_torch.driver.configs import grid_stretching_1d
    np.testing.assert_allclose(grid_stretching_1d(0.0, 2500.0, 10, stretch),
                               jax_stretching(0.0, 2500.0, 10, stretch),
                               rtol=1e-15, atol=0.0)


def test_interval_grammar_refuses_garbage():
    with pytest.raises(ValueError):
        driver.parse_interval("bogus", 1.0)


def test_settings_precedence(monkeypatch):
    """Command line, then environment, then keywords, then defaults, as
    the JAX package's."""
    monkeypatch.setenv("CLIMATEMACHINE_SETTINGS_SHOW_UPDATES", "7steps")
    for mod in (driver, jax_driver):
        assert mod.get_setting("show_updates", {}, dict(
            show_updates="3steps")) == "7steps"
        assert mod.get_setting("show_updates", {"show_updates": "9steps"},
                               {}) == "9steps"
        assert mod.get_setting("log_level", {}, {}) == "INFO"
    s = cm.init(parse_clargs=True, argv=["--disable-gpu", "true"])
    assert s.show_updates == "7steps" and s.disable_gpu
    cm.init(show_updates="never")


def test_summary_log_and_refusals(caplog, tmp_path):
    """``show_updates`` logs norm(Q) every N steps; the ``vtk`` and
    ``diagnostics`` interval settings, which no callback reads, refuse to
    run and name what to use; the monitors, adaptive time steps,
    checkpoints and restarts run (tests/test_torch_driver_checkpoint.py
    holds them against the JAX package); ``debug_init`` writes the
    initial state's VTK dump (as the JAX package's does,
    tests/test_driver_extras.py); ``invoke``'s ``diagnostics_config``
    fires its groups every N steps and leaves the state bit for bit as a
    run without it."""
    cm.init(show_updates="2steps")
    dc = cm.AtmosLESConfiguration("bubble", 2, (250.0, 250.0, 250.0),
                                  1000.0, 1000.0, 1000.0, port_model(),
                                  dtype=np.float64, device="cpu")
    sc = cm.make_solver_configuration(0.0, -1.0, dc, Courant_number=0.4)
    sc.timeend = 4 * sc.dt
    with caplog.at_level(logging.INFO, logger="climatemachine"):
        cm.invoke(sc)
    steps = [r.getMessage().split()[1] for r in caplog.records
             if r.getMessage().startswith("step ")]
    assert steps == ["2", "4"]
    for kw, name in ((dict(vtk="5steps"), "vtk_dump_state"),
                     (dict(diagnostics="1ssecs"), "diagnostics_config")):
        cm.init(show_updates="never", **kw)
        with pytest.raises(NotImplementedError, match=name):
            cm.invoke(sc)
    for kw in (dict(checkpoint="10steps"),
               dict(monitor_courant_numbers="1steps"),
               dict(monitor_timestep_duration="1steps"),
               dict(adapt_timestep="10steps"), dict(checkpoint_at_end=True)):
        cm.init(show_updates="never", checkpoint_dir=str(tmp_path), **kw)
        sc = cm.make_solver_configuration(0.0, -1.0, dc, Courant_number=0.4)
        sc.timeend = 2 * sc.dt
        assert np.isfinite(cm.invoke(sc))
    end_q, end_t = sc.q, sc.timeend
    cm.init(show_updates="never", debug_init=True,
            output_dir=str(tmp_path / "out"))
    sc = cm.make_solver_configuration(0.0, 1.0, dc)
    dump = readvtk(str(tmp_path / "out" / "bubble_init.vtu"))
    assert np.allclose(dump["rhoe"], sc.q[:, 4].reshape(-1).numpy(),
                       rtol=1e-9, atol=0.0)
    assert dump["points"].shape == (sc.dg.grid.nelem * sc.dg.grid.Np, 3)
    cm.init(show_updates="never")
    sc = cm.make_solver_configuration(0.0, 1.0, dc,
                                      restart_from=(str(tmp_path), 9999))
    assert sc.t0 == end_t and torch.equal(sc.q, end_q)
    runs = {}
    for diag in (False, True):
        sc = cm.make_solver_configuration(0.0, -1.0, dc, Courant_number=0.4)
        sc.timeend = 4 * sc.dt
        grp = AtmosLESDefaultGroup(sc.dg)
        writes = []
        grp.write = lambda q, aux, t, w=grp.write: writes.append(
            (t, w(q, aux, t)))
        cm.invoke(sc, diagnostics_config=cm.DiagnosticsConfiguration(
            (grp,), every_steps=2) if diag else None)
        runs[diag] = sc.q
    assert [t for t, _ in writes] == [2 * sc.dt, 4 * sc.dt]
    assert all(np.isfinite(v["rho"]).all() for _, v in writes)
    assert torch.equal(runs[True], runs[False])
