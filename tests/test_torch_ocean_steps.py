"""Time steps of the ocean in the port against the JAX package's, in
float64 on the CPU, each within 1e-10 of the JAX state's largest
magnitude per variable:

- 3 LSRK144 steps with ``pre_stage`` of OceanGyre on the 3 × 2 × 3 box
  at p3 of each package's ``ocean_box_grid``, the port's through its
  ``experiments/ocean_box.py`` solver and ``solve``, from the initial
  state plus noise (numpy seed 0); LSRKEulerMethod and LSRK54 one step;
- one step of each integrator of ode/lsrk3n.py: LS3NRK44Classic and
  LS3NRK33Heuns with ``pre_stage``, LS3NRK33Heuns3N (the 3N-register
  form) without, and it against the Butcher form;
- HydrostaticBoussinesqSuperModel, the geostrophic adjustment of
  tests/test_ocean.py:155 at Ne = (6, 1, 2), p3 (y periodic and one
  element wide: each element its own y neighbour), 4 steps: ``fields``,
  ``cartesian_field`` (``elements`` and ``assemble()``) against the JAX
  model's; and the port alone at the test's own configuration (Ne = (20,
  1, 1), p4, 36 steps) with its assertions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init
from climatemachine_tpu.ode import lsrk as jlsrk
from climatemachine_tpu.ode import lsrk3n as jlsrk3n
from climatemachine_tpu.ocean import problems as jpr
from climatemachine_tpu.ocean import super_model as jsm
from climatemachine_tpu_torch.experiments.ocean_box import ocean_box_config
from climatemachine_tpu_torch.ode import lsrk, lsrk3n
from climatemachine_tpu_torch.ode.solve import solve
from climatemachine_tpu_torch.ocean import super_model as psm
from ocean_parity import (H, L, NE, POLY, models, nm, perturbed,
                          rel_err_per_var, vm)

TOL = 1e-10
DT = 120.0


@pytest.fixture(scope="module")
def gyre():
    """The JAX gyre on its ``ocean_box_grid`` (3 × 2 × 3 at p3, as
    ``examples/ocean_box_gcm.py`` builds it), its jitted RHS and
    pre-stage; the port's ``ocean_box_config`` of the same box; the
    perturbed initial state."""
    mj, _ = models("gyre")
    gj = jpr.ocean_box_grid(mj.problem, *NE, 3, POLY, dtype=np.float64)
    dj = JaxDGModel(mj, gj)
    qj, aj = jax_init(dj)
    # the JAX model caches its column operators and filters at their
    # first use: built here, outside a trace, the jitted functions below
    # may retrace (t as a python or a numpy float) without a leaked tracer
    mj._cols(gj)
    mj._vert_filters(gj)
    dg, q0, aux0, solver = ocean_box_config(
        "gyre", NE + (3,), POLY, (L, L, H), DT, device="cpu")
    q = perturbed(qj)
    return dict(rhs=jax.jit(lambda q, a, t: dj(q, a, t)),
                pre=jax.jit(lambda q, a, t: dj.pre_stage(q, a, t)),
                qj=jnp.asarray(q), aj=aj, dg=dg, q=vm(q), aux=vm(aj),
                solver=solver, q0=(qj, aj, q0, aux0))


def _steps(step, q, aux, n, dt=DT):
    for i in range(n):
        q, aux = step(q, aux, i * dt)
    return q, aux


def test_ocean_box_config_initial_state(gyre):
    qj, aj, q0, aux0 = gyre["q0"]
    assert gyre["dg"].grid.nelem == 18 and gyre["solver"].nstages == 14
    assert max(rel_err_per_var(nm(q0), qj)) < 1e-14
    assert max(rel_err_per_var(nm(aux0), aj)) < 1e-14


def test_lsrk144_three_steps(gyre):
    g = gyre
    qj, aj = _steps(jlsrk.LSRK144NiegemannDiehlBusch(
        g["rhs"], DT, pre_stage=g["pre"]).step, g["qj"], g["aj"], 3)
    st = solve(g["q"], g["aux"], g["solver"], 3 * DT)
    assert st.step == 3
    assert max(rel_err_per_var(nm(st.q), qj)) < TOL
    assert max(rel_err_per_var(nm(st.aux), aj)) < TOL


@pytest.mark.parametrize("name", ["LSRKEulerMethod", "LSRK54CarpenterKennedy",
                                  "LS3NRK44Classic", "LS3NRK33Heuns",
                                  "LS3NRK33Heuns3N"])
def test_one_step(gyre, name):
    g = gyre
    jmod = jlsrk3n if name.startswith("LS3N") else jlsrk
    pmod = lsrk3n if name.startswith("LS3N") else lsrk
    kw = lambda pre: {} if name.endswith("3N") else dict(pre_stage=pre)
    qj, _ = getattr(jmod, name)(g["rhs"], DT, **kw(g["pre"])).step(
        g["qj"], g["aj"], 0.0)
    qt, _ = getattr(pmod, name)(g["dg"], DT, **kw(g["dg"].pre_stage)).step(
        g["q"], g["aux"], 0.0)
    assert max(rel_err_per_var(nm(qt), qj)) < TOL


def test_heuns_3n_is_the_butcher_form(gyre):
    g = gyre
    a = lsrk3n.LS3NRK33Heuns3N(g["dg"], DT).step(g["q"], g["aux"], 0.0)[0]
    b = lsrk3n.LS3NRK33Heuns(g["dg"], DT).step(g["q"], g["aux"], 0.0)[0]
    assert max(rel_err_per_var(nm(a), nm(b))) < 1e-12


def _adjustment(mod, exp, Ne, Np, dtype_kw):
    """The geostrophic adjustment of tests/test_ocean.py:155."""
    Lx, f, g = 1e6, 1e-4, 9.81
    U, Lg = 0.1, Lx / 40
    a, x0 = f * U * Lg / g, Lx / 4
    gauss = lambda x: exp(-x ** 2 / (2 * Lg ** 2))
    domain = mod.RectangularDomain(Ne=Ne, Np=Np, x=(0, Lx), y=(0, Lx),
                                   z=(-400.0, 0.0),
                                   periodicity=(False, True, False))
    model = mod.HydrostaticBoussinesqSuperModel(
        domain, time_step=100.0,
        initial_conditions=mod.InitialConditions(
            v=lambda x, y, z: -U * (x - x0) / Lg * gauss(x - x0),
            eta=lambda x, y, z: 2 * a * gauss(x - x0)),
        coriolis=dict(f_0=f, beta=0.0),
        turbulence_closure=dict(nu_h=1e3, nu_z=1e-2, kappa_h=1e3,
                                kappa_z=1e-4),
        rusanov_wave_speeds=dict(c_h=float(np.sqrt(g * 400.0)), c_z=1e-3),
        **dtype_kw)
    return model, a, x0, Lg


def test_super_model_matches_jax():
    mj, *_ = _adjustment(jsm, jnp.exp, (6, 1, 2), 3, {})
    mt, *_ = _adjustment(psm, torch.exp, (6, 1, 2), 3, dict(device="cpu"))
    mj.step(4)
    mt.step(4)
    assert mt.step_count == mj.step_count == 4
    assert mt.time == mj.time
    for name in ("u", "v", "eta", "theta"):
        ref = np.asarray(mj.fields[name])
        got = mt.fields[name].numpy()
        assert np.abs(got - ref).max() <= TOL * max(np.abs(ref).max(), 1e-30)
    for name in ("v", "eta"):
        cj, ct = mj.cartesian_field(name), mt.cartesian_field(name)
        for got, ref in ((ct.elements, cj.elements),
                         (ct.assemble(), cj.assemble())):
            ref = np.asarray(ref)
            assert got.shape == ref.shape
            assert np.abs(got.numpy() - ref).max() <= TOL * np.abs(ref).max()
        for ax in "xyz":
            np.testing.assert_allclose(getattr(ct, ax), getattr(cj, ax),
                                       rtol=1e-15)


def test_super_model_geostrophic_adjustment():
    """The assertions of tests/test_ocean.py:185-200 on the port."""
    model, a, x0, Lg = _adjustment(psm, torch.exp, (20, 1, 1), 4,
                                   dict(device="cpu"))
    M = model.grid.M.numpy()
    eta0 = model.fields["eta"].numpy().copy()
    vol0 = float((M * eta0).sum())
    model.solve(until=3600.0)
    assert model.step_count == 36
    eta1 = model.fields["eta"].numpy()
    assert np.isfinite(eta1).all()
    assert abs(float((M * eta1).sum()) - vol0) <= 1e-10 * abs(
        M.sum() * a) + 1e-12
    assert eta1.max() < 0.95 * eta0.max()
    x = model.grid.coords[..., 0].numpy()
    far = np.abs(x - x0) > 4 * Lg
    assert np.abs(eta1[far]).max() > 10 * np.abs(eta0[far]).max()
