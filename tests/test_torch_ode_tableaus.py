"""The port's time-integrator tableaus and stage algebra against the JAX
package's, on scalar problems in float64 on the CPU (no DG operator):

- each ARK tableau (ode/ark.py) equal to the JAX one entry for entry,
  B_ex = B_im (the full-RHS block loop's cancellation needs it), and ten
  steps of the split problem q' = λ_ex q + λ_im q against the JAX steps,
  1e-14; the convergence orders of tests/test_imex.py:173-203 (and 1 and
  2 for ARK1 and the IMEX midpoint);
- the SSPRK methods (ode/ssprk.py): ten steps of q' = −q + sin t against
  JAX, 1e-15, and the orders of tests/test_solvers_fluxes.py:33-46;
- MIS2, MIS3C, MISRK3 (ode/mis.py) with LSRK54 and SSPRK33 fast steps:
  ten steps against JAX, 1e-15, and the orders of
  tests/test_solvers_fluxes.py:70-101;
- the MRI-GARK schemes (ode/mrigark.py): ten steps against JAX with a
  time-dependent slow operator, 1e-15, the orders and the Δc sums of
  tests/test_mrigark.py;
- the Dormand-Prince stepper (ode/external.py) against the JAX
  ``ExternalODESolver`` (``jax.experimental.ode.odeint``): as many
  right-hand-side evaluations, at the same times (so the same initial
  step and the same attempted steps, each accepted or rejected alike)
  within 1e-8 relative, and the result within 1e-12 of JAX's and 1e-8 of
  the exact solution (tests/test_driver_extras.py:180).  The times are
  not bit-equal: the error estimate is a difference of nearly equal
  stage sums, which the two order differently, and its round-off moves
  each next step size by ~1e-12, compounding over the 384 evaluations to
  4.6e-10 of a time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.ode import ark as jark
from climatemachine_tpu.ode import mis as jmis
from climatemachine_tpu.ode import mrigark as jmri
from climatemachine_tpu.ode import ssprk as jssprk
from climatemachine_tpu.ode.external import ExternalODESolver as JaxExternal
from climatemachine_tpu.ode.lsrk import LSRK54CarpenterKennedy as JaxLSRK54
from climatemachine_tpu.ode.solve import solve as jax_solve
from climatemachine_tpu_torch.ode import ark, mis, mrigark, ssprk
from climatemachine_tpu_torch.ode.external import ExternalODESolver
from climatemachine_tpu_torch.ode.lsrk import LSRK54CarpenterKennedy
from climatemachine_tpu_torch.ode.solve import solve
from numerics_parity import one_torch_thread  # noqa: F401

ARK = ["ARK1ForwardBackwardEuler", "ARK2ImplicitExplicitMidpoint",
       "ARK2GiraldoKellyConstantinescu", "ARK548L2SA2KennedyCarpenter",
       "ARK437L2SA1KennedyCarpenter", "DBM453VoglEtAl"]
ARK_ORDER = {"ARK1ForwardBackwardEuler": 1, "ARK2ImplicitExplicitMidpoint": 2,
             "ARK2GiraldoKellyConstantinescu": 2, "DBM453VoglEtAl": 3,
             "ARK437L2SA1KennedyCarpenter": 4,
             "ARK548L2SA2KennedyCarpenter": 5}
SSPRK = {"SSPRK22Heuns": 2, "SSPRK22Ralstons": 2, "SSPRK33ShuOsher": 3,
         "SSPRK34SpiteriRuuth": 3}
MIS = ["MIS2", "MIS3C", "MISRK3"]
MRI_EXPLICIT = {"MRIGARKERK33aSandu": 3, "MRIGARKERK45aSandu": 4}
MRI_IMPLICIT = {"MRIGARKIRK21aSandu": 2, "MRIGARKESDIRK34aSandu": 3,
                "MRIGARKESDIRK46aSandu": 4}
LAM_EX, LAM_IM = -0.6, -3.0
LAM_S, LAM_F = -0.4, -4.0


def t64(v):
    return torch.tensor(v, dtype=torch.float64)


def _run(solver, q, n, dt):
    aux, t = None, 0.0
    for _ in range(n):
        q, aux = solver.step(q, aux, t)
        t += dt
    return float(q[0])


class _Implicit:
    """(I − α λ)⁻¹ for a scalar linear operator λ."""

    def __init__(self, lam):
        self.lam = lam

    def solve(self, rhs, alpha_dt):
        return rhs / (1.0 - alpha_dt * self.lam)


# --- ARK ------------------------------------------------------------------

@pytest.mark.parametrize("name", ARK)
def test_ark_tableau_matches_jax(name):
    a = getattr(jark, name)(None, None, None, 1.0)
    b = getattr(ark, name)(None, None, None, 1.0)
    for field in ("A_ex", "A_im", "B", "C"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field
    # one weight vector for both parts (B_ex = B_im: the full-RHS block
    # loop's cancellation), an explicit A_ex, an ESDIRK A_im with one γ
    # (one factorization) and a first stage without an implicit part;
    # both parts consistent with C
    s = b.nstages
    assert b.B.shape == (s,) and np.isclose(b.B.sum(), 1.0)
    assert np.array_equal(np.tril(b.A_ex, -1), b.A_ex)
    assert np.array_equal(np.tril(b.A_im), b.A_im) and b.A_im[0, 0] == 0
    assert len({b.A_im[i, i] for i in range(1, s)}) == 1
    assert np.allclose(b.A_ex.sum(axis=1), b.C, atol=1e-10)
    assert np.allclose(b.A_im.sum(axis=1), b.C, atol=1e-10)


def _ark(mod, name, dt):
    return getattr(mod, name)(lambda q, a, t: (LAM_EX * q, a),
                              lambda q, a, t: (LAM_IM * q, a),
                              _Implicit(LAM_IM), dt)


@pytest.mark.parametrize("name", ARK)
def test_ark_steps_match_jax(name):
    ref = _run(_ark(jark, name, 0.1), jnp.asarray([1.0]), 10, 0.1)
    got = _run(_ark(ark, name, 0.1), t64([1.0]), 10, 0.1)
    assert abs(got - ref) < 1e-14 * abs(ref), (got, ref)


@pytest.mark.parametrize("name", ARK)
def test_ark_convergence_order(name):
    exact = np.exp(LAM_EX + LAM_IM)
    e1, e2 = (abs(_run(_ark(ark, name, 1.0 / n), t64([1.0]), n, 1.0 / n)
                  - exact) for n in (8, 16))
    p = np.log2(e1 / e2)
    assert p > ARK_ORDER[name] - 0.6, (p, e1, e2)


# --- SSPRK ----------------------------------------------------------------

def _ssprk(mod, name, dt):
    return getattr(mod, name)(lambda q, a, t: (-q + np.sin(t), a), dt)


@pytest.mark.parametrize("name", SSPRK)
def test_ssprk_steps_match_jax(name):
    ref = _run(_ssprk(jssprk, name, 0.1), jnp.asarray([1.0]), 10, 0.1)
    got = _run(_ssprk(ssprk, name, 0.1), t64([1.0]), 10, 0.1)
    assert abs(got - ref) < 1e-15, (got, ref)


@pytest.mark.parametrize("name", SSPRK)
def test_ssprk_convergence_order(name):
    errs = []
    for n in (20, 40):
        s = getattr(ssprk, name)(lambda q, a, t: (-q, a), 1.0 / n)
        errs.append(abs(_run(s, t64([1.0]), n, 1.0 / n) - np.exp(-1.0)))
    p = np.log2(errs[0] / errs[1])
    assert p > SSPRK[name] - 0.35, p


def test_ssprk_post_step_runs_once():
    seen = []
    s = ssprk.SSPRK33ShuOsher(lambda q, a, t: (-q, a), 0.1,
                              post_step=lambda q, a: seen.append(1) or q)
    s.step(t64([1.0]), None, 0.0)
    assert seen == [1] and s.nstages == 3


# --- MIS ------------------------------------------------------------------

def _mis(mod, name, fast, dt, nsub=8):
    return getattr(mod, name)(lambda q, a, t: (LAM_S * q, a),
                              lambda q, a, t: (LAM_F * q, a),
                              lambda rhs, d: fast(rhs, d), nsubsteps=nsub,
                              dt=dt)


@pytest.mark.parametrize("fast", ["LSRK54", "SSPRK33"])
@pytest.mark.parametrize("name", MIS)
def test_mis_steps_match_jax(name, fast):
    jf, tf = {"LSRK54": (JaxLSRK54, LSRK54CarpenterKennedy),
              "SSPRK33": (jssprk.SSPRK33ShuOsher,
                          ssprk.SSPRK33ShuOsher)}[fast]
    ref = _run(_mis(jmis, name, jf, 0.1), jnp.asarray([1.0]), 10, 0.1)
    got = _run(_mis(mis, name, tf, 0.1), t64([1.0]), 10, 0.1)
    assert abs(got - ref) < 1e-15, (got, ref)


@pytest.mark.parametrize("name", MIS)
def test_mis_convergence(name):
    """Order 2 on this additive linear split, as the JAX test reads it."""
    exact = np.exp(LAM_S + LAM_F)
    e1, e2 = (abs(_run(_mis(mis, name, LSRK54CarpenterKennedy, 1.0 / n),
                       t64([1.0]), n, 1.0 / n) - exact) for n in (10, 20))
    assert e1 < 1e-3, e1
    assert np.log2(e1 / e2) > 1.5, (e1, e2)


# --- MRI-GARK -------------------------------------------------------------

def _slow(q, a, t):
    return LAM_S * (1.0 + 0.1 * np.sin(t)) * q, a


def _mri(mod, name, dt, fast=None, nsub=12):
    fast = fast or (JaxLSRK54 if mod is jmri else LSRK54CarpenterKennedy)
    args = (_slow, lambda q, a, t: (LAM_F * q, a),
            lambda rhs, d: fast(rhs, d), nsub)
    if name in MRI_EXPLICIT:
        return getattr(mod, name)(*args, dt)
    return getattr(mod, name)(*args, _Implicit(LAM_S), dt)


@pytest.mark.parametrize("name", list(MRI_EXPLICIT) + list(MRI_IMPLICIT))
def test_mrigark_steps_match_jax(name):
    ref = _run(_mri(jmri, name, 0.1), jnp.asarray([1.0]), 10, 0.1)
    got = _run(_mri(mrigark, name, 0.1), t64([1.0]), 10, 0.1)
    assert abs(got - ref) < 1e-15, (got, ref)


@pytest.mark.parametrize("name", list(MRI_EXPLICIT) + list(MRI_IMPLICIT))
def test_mrigark_order_and_consistency(name):
    order = {**MRI_EXPLICIT, **MRI_IMPLICIT}[name]

    def err(n):
        s = getattr(mrigark, name)(
            lambda q, a, t: (LAM_S * q, a), lambda q, a, t: (LAM_F * q, a),
            lambda rhs, d: LSRK54CarpenterKennedy(rhs, d), 12,
            *(() if name in MRI_EXPLICIT else (_Implicit(LAM_S),)), 1.0 / n)
        return abs(_run(s, t64([1.0]), n, 1.0 / n)
                   - np.exp(LAM_S + LAM_F)), s

    (e1, s), (e2, _) = err(10), err(20)
    assert np.isclose(s.dc.sum(), 1.0)
    assert e1 < (1e-4 if name in MRI_EXPLICIT else 5e-3), e1
    assert np.log2(e1 / e2) > order - 0.6, (e1, e2)


def test_mrigark_ceil_substeps():
    assert mrigark._ceil_substeps(12, 1 / 3) == jmri._ceil_substeps(12, 1 / 3)
    assert mrigark._ceil_substeps(12, 1e-9) == 1
    assert mrigark._ceil_substeps(10, 0.25) == 3


# --- Dormand-Prince ---------------------------------------------------------

def test_external_stepper_matches_jax_odeint():
    """dq/dt = −q + sin t from q0 over [0, 2] in windows of 0.25: both
    record the times of their RHS evaluations."""
    seen_j, seen_t = [], []

    def rhs_j(q, aux, t):
        jax.debug.callback(lambda s: seen_j.append(float(s)), t,
                           ordered=True)
        return -q + jnp.sin(t), aux

    def rhs_t(q, aux, t):
        seen_t.append(float(t))
        return -q + np.sin(t), aux

    q0 = np.linspace(0.5, 1.5, 12).reshape(4, 3)
    st_j = jax_solve(jnp.asarray(q0), jnp.zeros((1,)),
                     JaxExternal(rhs_j, 0.25, rtol=1e-10, atol=1e-12), 2.0)
    jax.effects_barrier()
    ext = ExternalODESolver(rhs_t, 0.25, rtol=1e-10, atol=1e-12)
    st_t = solve(t64(q0), torch.zeros(1, dtype=torch.float64), ext, 2.0)
    assert len(seen_t) == len(seen_j) > 8 * 8
    assert np.allclose(seen_t, seen_j, rtol=1e-8, atol=0)
    assert np.abs(st_t.q.numpy() - np.asarray(st_j.q)).max() < 1e-12
    exact = (q0 + 0.5) * np.exp(-2.0) + (np.sin(2.0) - np.cos(2.0)) / 2
    assert np.abs(st_t.q.numpy() - exact).max() < 1e-8
