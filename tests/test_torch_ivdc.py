"""The implicit vertical diffusive convection (IVDC) in the port against
the JAX package's, in float64 on the CPU (GMRES itself:
tests/test_torch_gmres.py):

- the central-flux DG gradient ``dg_gradient_of`` of θ in the vertical
  and in every direction, ``ivdc_coefficients`` (κᶜ where ∂θ/∂z < 0,
  κᶻ/2 elsewhere) and one ``ivdc_solve`` (12 Krylov vectors, 2
  restarts) on the gyre of tests/ocean_parity.py's 3 × 2 × 3 box at p3,
  θ with noise so that both diffusivities occur, within 1e-11 per
  variable, and its GMRES residual;
- the IVDC operator built once per (Δt, κᶻ, κᶜ) and reused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.ocean import ivdc as jivdc
from climatemachine_tpu.ocean import split_explicit as jse
from climatemachine_tpu.solvers.iterative import gmres as jax_gmres
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.ocean import ivdc as pivdc
from climatemachine_tpu_torch.ocean import split_explicit as pse
from ocean_parity import grids, nm, perturbed, rel_err_per_var, vm
from split_explicit_parity import problems

TOL = 1e-11


@pytest.fixture(scope="module")
def gyre():
    """The coupled gyre on the box in both packages, θ ± 1 so that the
    stratification is unstable at some nodes."""
    pj, pt = problems("gyre")
    mj = jse.CoupledHBModel(pj, c_h=1.0, kappa_c=0.1)
    mt = pse.CoupledHBModel(pt, c_h=1.0, kappa_c=0.1)
    gj, gt = grids()
    dj = JaxDGModel(mj, gj)
    dg = DGModel(mt, gt)
    # the port's initial state (test_torch_split_explicit.py holds it
    # against the JAX package's): an eager JAX init costs seconds
    q0, aux = init_ode_state(dg)
    q = perturbed(nm(q0), 4)
    return dict(mj=mj, mt=mt, dj=dj, dg=dg, qj=jnp.asarray(q),
                aj=jnp.asarray(nm(aux)), q=vm(q), aux=aux)


@pytest.mark.parametrize("direction", ["vertical", "every"])
def test_dg_gradient_of(gyre, direction):
    g = gyre
    th_j = g["mj"].prog(g["qj"], "theta")[..., None]
    ref = np.asarray(jax.jit(lambda x: g["dj"].dg_gradient_of(
        x, direction=direction))(th_j))
    got = g["dg"].dg_gradient_of(g["mt"].prog(g["q"], "theta")[:, None],
                                 direction=direction)
    got = got.permute(0, 3, 1, 2).numpy()                # [E, Np, 3, 1]
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def _jax_coefficients(g, coefficients=jivdc.ivdc_coefficients):
    return jax.jit(lambda q, a: coefficients(g["mj"], g["dj"], q, a))


def test_ivdc_coefficients(gyre):
    g = gyre
    kj = np.asarray(_jax_coefficients(g)(g["qj"], g["aj"]))
    kt = pivdc.ivdc_coefficients(g["mt"], g["dg"], g["q"], g["aux"])
    np.testing.assert_array_equal(kt.numpy(), kj)
    # both branches occur
    assert set(np.unique(kj)) == {g["mt"].kappa_c, 0.5 * g["mt"].kappa_z}


def test_ivdc_solve(gyre, monkeypatch):
    """At 12 Krylov vectors and 2 restarts (the card path's 24 converge
    no further on this box).  The JAX solve runs its GMRES eagerly around
    its operator and its κ, each jitted here (the solve jitted whole
    compiles for longer than it runs eagerly, and eagerly each operator
    application costs a tenth of a second)."""
    g = gyre
    dt = 5400.0 / 5
    monkeypatch.setattr(jivdc, "gmres", lambda op, b, **kw: jax_gmres(
        jax.jit(op), b, **kw))
    coefficients = _jax_coefficients(g)
    monkeypatch.setattr(jivdc, "ivdc_coefficients",
                        lambda m, d, q, a: coefficients(q, a))
    kw = dict(n_krylov=12, restarts=2)
    qj = jivdc.ivdc_solve(g["mj"], g["dj"], g["qj"], g["aj"], dt, **kw)
    qt, res = pivdc.ivdc_solve(g["mt"], g["dg"], g["q"], g["aux"], dt, **kw)
    assert max(rel_err_per_var(nm(qt), qj)) < TOL
    # θ changed, the rest did not
    th = g["mt"].prog_spec.index("theta").start
    assert torch.equal(torch.cat([qt[:, :th], qt[:, th + 1:]], 1),
                       torch.cat([g["q"][:, :th], g["q"][:, th + 1:]], 1))
    assert (qt[:, th] - g["q"][:, th]).abs().max() > 1e-3
    assert float(res) < 1e-10          # ‖b − Lx‖ / ‖b‖, b = θⁿ/Δt


def test_ivdc_operator_cached(gyre):
    g = gyre
    a = pivdc._operator(g["mt"], g["dg"], 100.0)
    assert pivdc._operator(g["mt"], g["dg"], 100.0) is a
    assert pivdc._operator(g["mt"], g["dg"], 200.0) is not a
    dg_op, aux0 = a
    assert dg_op.direction == "vertical" and dg_op.n_gradient == 1
    assert dg_op.balance_law.dt == 100.0
