"""The invoke parity tests of the port's driver entry
(AtmosLESConfiguration → make_solver_configuration → invoke) against the
JAX package's, shared by tests/test_torch_les_driver.py (SmagorinskyLilly,
on the generic DG operator) and tests/test_torch_les_driver_inviscid.py
(no closure, on the var-major RHS, which "auto" takes in both packages):
one closure a file, so that each file's JAX ``invoke`` compiles its step
once.

The configuration is tests/test_driver.py's LES one (:60-78, without the
checkpoint): the rising bubble of tests/les_parity.py in a 1000 m box at
Δ = 50 m and p4 (5 × 5 × 5 elements), Courant number 0.4, 10 LSRK54
steps, float64 on the CPU.

- dt from ``calculate_dt`` and the Courant numbers in each direction
  within 1e-12 relative;
- the state after ``invoke``'s 10 steps within 1e-10 per variable of
  the JAX package's (relative to its largest magnitude of the variable,
  the momentum's components over the largest) and the same norm ratio;
- the bubble rises (max w > 1e-4 m/s) and mass is conserved to 1e-11,
  as tests/test_atmos_dry.py:88-150 asks.

A test file imports the ``test_*`` functions below and sets its
``runs`` fixture with :func:`runs_fixture`.
"""

import numpy as np
import pytest

from climatemachine_tpu import driver_api as jcm
from climatemachine_tpu_torch import driver_api as cm
from climatemachine_tpu_torch.dg import courant
from les_parity import jax_model, nm, port_model, rel_err_per_var

N_STEPS = 10
TOL = 1e-10
CLOSURES = {"smagorinsky": lambda m: m.SmagorinskyLilly(0.21),
            "inviscid": lambda m: None}


def _configs(pkg, model, **kw):
    dc = pkg.AtmosLESConfiguration("bubble", 4, (50.0, 50.0, 50.0), 1000.0,
                                   1000.0, 1000.0, model, dtype=np.float64,
                                   **kw)
    sc = pkg.make_solver_configuration(0.0, -1.0, dc, Courant_number=0.4)
    sc.timeend = N_STEPS * sc.dt
    return dc, sc


def runs_fixture(key):
    """A module fixture ``runs`` giving (key, out): both packages'
    configuration with closure ``key``, its initial state, and the ratio
    ``invoke`` returned after N_STEPS steps."""
    @pytest.fixture(scope="module", name="runs")
    def runs():
        return key, _run_both(key)
    return runs


def _run_both(key):
    jcm.init(show_updates="never")
    cm.init(show_updates="never")
    out = {}
    for name, pkg, build, kw in (("jax", jcm, jax_model, {}),
                                 ("port", cm, port_model,
                                  dict(device="cpu"))):
        model = build(turbulence=CLOSURES[key](pkg))
        dc, sc = _configs(pkg, model, **kw)
        q0 = np.asarray(sc.q) if name == "jax" else nm(sc.q)
        ratio = pkg.invoke(sc)
        out[name] = dict(model=model, dc=dc, sc=sc, q0=q0, ratio=ratio)
    return out


def test_dt_matches_jax(runs):
    _, out = runs
    dj, dp = out["jax"]["sc"].dt, out["port"]["sc"].dt
    assert abs(dp - dj) <= 1e-12 * dj


def test_invoke_matches_jax(runs):
    key, out = runs
    sj, sp = out["jax"]["sc"], out["port"]["sc"]
    assert (sp.solver.vm is None) == (key == "smagorinsky")
    assert (getattr(sj.solver, "vm", None) is None) == (key == "smagorinsky")
    err = rel_err_per_var(nm(sp.q), sj.q)
    assert np.all(err <= TOL), err
    assert abs(out["port"]["ratio"] - out["jax"]["ratio"]) <= 1e-12
    assert list(sp.q.shape) == [125, 5, 125]


def test_bubble_rises_and_conserves_mass(runs):
    _, out = runs
    sc, q0 = out["port"]["sc"], out["port"]["q0"]
    q = nm(sc.q)
    assert np.all(np.isfinite(q))
    M = sc.dg.grid.M.numpy()
    mass = lambda a: np.sum(M * a[..., 0])
    assert abs(mass(q) - mass(q0)) / mass(q0) <= 1e-11
    w = q[..., 3] / q[..., 0]
    assert w.max() > 1e-4


@pytest.mark.parametrize("direction", ["every", "horizontal", "vertical"])
@pytest.mark.parametrize("local", ["nondiffusive_courant",
                                   "advective_courant"])
def test_courant_matches_jax(runs, direction, local):
    _, out = runs
    from climatemachine_tpu.dg import courant as jax_courant
    j, p = out["jax"], out["port"]
    ref = jax_courant.calculate_dt(j["dc"].grid, j["model"], j["sc"].q,
                                   j["sc"].aux, 0.4, direction,
                                   getattr(jax_courant, local))
    got = courant.calculate_dt(p["dc"].grid, p["model"], p["sc"].q,
                               p["sc"].aux, 0.4, direction,
                               getattr(courant, local))
    assert abs(got - ref) <= 1e-12 * ref
