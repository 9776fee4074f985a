"""The split-explicit ocean's split01 variants and ``batched_gmres`` in
the port against the JAX package's, in float64 on the CPU:

- ``SplitExplicitSolver(variant="split01")`` (LSRK54 slow at 600 s and
  fast at 120 s, ``add_fast_substeps`` 2, 5 IVDC solves at dt/5 with κᶜ
  = 0.1) and ``variant="split01_3n"`` (LS3NRK33Heuns3N slow and fast,
  ``add_fast_substeps`` 3, 5 IVDC solves) on the gyre of
  tests/ocean_parity.py's 3 × 2 × 3 box at p3 and the 3 × 2 brick, from
  the initial state plus noise, 2 slow steps: every prognostic and
  every aux lane (U_c, η_c, U_s, η_s, η_diag, Δη, Δu, Gᵁ, ΔGᵘ, uᵈ, w,
  pkin, wz0) within 1e-10 per variable, and each GMRES residual below
  1e-10;
- the fast windows (k_lo, k_save, k_hi) of both variants against the
  JAX loop's arithmetic;
- ``batched_gmres`` on the cases of tests/test_iterative_solvers.py:34
  and :123 (a batch of dense systems, a batch-dependent operator)
  against the JAX function, x within 1e-10 and each residual below
  1e-8; and at an Arnoldi breakdown (an operator that is a multiple of
  the identity), the minimum-norm answer.

The JAX references step eagerly around jitted RHS (tests/
split_explicit_parity.py ``Jitted``); their IVDC solves
(``JittedJaxIVDC``) are jitted once per Δt: the JAX ``ivdc_solve`` builds
a new operator each call and runs its GMRES eagerly, 3.7 s for the 5
solves of a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import \
    init_state_auxiliary as jax_init_aux
from climatemachine_tpu.ocean import ivdc as jivdc
from climatemachine_tpu.ocean import split_explicit as jse
from climatemachine_tpu.ode import lsrk as jlsrk
from climatemachine_tpu.ode import lsrk3n as jlsrk3n
from climatemachine_tpu.solvers import iterative as jit_solvers
from climatemachine_tpu_torch.ocean import split_explicit as pse
from climatemachine_tpu_torch.ode import lsrk, lsrk3n
from climatemachine_tpu_torch.solvers.iterative import batched_gmres
from ocean_parity import nm, rel_err_per_var
from test_torch_split_explicit import assert_pairs_close, setup

DT, DT_FAST = 600.0, 120.0
IMPL = 5
STEP_TOL = 1e-10
GMRES_TOL = 1e-10
VARIANTS = {"split01": (2, jlsrk.LSRK54CarpenterKennedy,
                        lsrk.LSRK54CarpenterKennedy),
            "split01_3n": (3, jlsrk3n.LS3NRK33Heuns3N,
                           lsrk3n.LS3NRK33Heuns3N)}
SPLIT01_AUX = ("U_c", "eta_c", "U_s", "eta_s", "eta_diag", "deta", "du",
               "GU")


class JittedJaxIVDC:
    """The JAX ``ivdc_solve`` with its GMRES run by the JAX package's
    ``batched_gmres`` on a batch of one (the same Krylov space and
    restarts, classical Gram-Schmidt in a ``fori_loop``), the whole
    jitted once per Δt.  The JAX ``gmres`` unrolls its Gram-Schmidt in
    Python: eagerly 0.7 s a solve here, jitted a long compile.  The
    port's ``gmres`` against the JAX one is tests/test_torch_gmres.py
    and tests/test_torch_ivdc.py; both solves converge below
    GMRES_TOL."""

    def __init__(self, dj):
        self.dj = dj
        self.solves = {}

    def __call__(self, model, dg_hb, q, aux, dt, n_krylov=24, restarts=2):
        if dt not in self.solves:
            ivdc = jivdc.IVDCModel(model.kappa_z, model.kappa_c, dt)
            dg_op = JaxDGModel(ivdc, self.dj.grid, direction="vertical")
            aux0 = jax_init_aux(ivdc, self.dj.grid)

            def solve(q, aux):
                kap = jivdc.ivdc_coefficients(model, self.dj, q, aux)
                aux_op = ivdc.aux_spec.set(aux0, "kappa", kap)
                theta_n = model.prog(q, "theta")[..., None]
                sol, _ = jit_solvers.batched_gmres(
                    lambda x: dg_op(x.reshape(theta_n.shape), aux_op,
                                    0.0)[0].reshape(1, -1),
                    (theta_n / dt).reshape(1, -1), n_krylov=n_krylov,
                    restarts=restarts)
                return model.prog_spec.set(
                    q, "theta", sol.reshape(theta_n.shape)[..., 0])

            self.solves[dt] = jax.jit(solve)
        return self.solves[dt](q, aux)


def solvers(s, variant):
    """(the JAX solver, the port's) of ``variant`` on setup ``s``."""
    _, jmethod, pmethod = VARIANTS[variant]
    sj = jse.SplitExplicitSolver(jmethod(s["d3j"], DT),
                                 jmethod(s["d2j"], DT_FAST), s["d3j"],
                                 s["d2j"], dt=DT, fast_dt=DT_FAST,
                                 variant=variant)
    st = pse.SplitExplicitSolver(pmethod(s["d3"], DT),
                                 pmethod(s["d2"], DT_FAST), s["d3"], s["d2"],
                                 dt=DT, fast_dt=DT_FAST, variant=variant)
    return sj, st


@pytest.fixture(scope="module")
def base():
    """Both packages' operators and the noisy state pair with the IVDC
    schedule on the 3-D model, and the cached JAX IVDC; the variants
    share them (their ``add_fast_substeps`` is set per variant: the
    models read it in no RHS)."""
    s = setup(True, seed=5, num_impl_steps=IMPL, ivdc_dt=DT / IMPL)
    s["ivdc"] = JittedJaxIVDC(s["d3j"].dg)
    return s


@pytest.fixture(scope="module", params=list(VARIANTS))
def two_steps(request, base):
    """Two slow steps of the variant in both packages: (setup, JAX
    (q, aux), the port's (q, aux), the port's GMRES residuals)."""
    variant = request.param
    s = base
    for m in (s["d3j"].balance_law, s["d3"].balance_law):
        m.add_fast_substeps = VARIANTS[variant][0]
    sj, st = solvers(s, variant)
    qj, aj, q, aux = s["qj"], s["aj"], s["q"], s["aux"]
    residuals = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jivdc, "ivdc_solve", s["ivdc"])
        for i in range(2):
            qj, aj = sj.step(qj, aj, i * DT)
            q, aux = st.step(q, aux, i * DT)
            residuals += [float(r) for r in st.ivdc_residuals]
    return dict(s=s, st=st, ref=(qj, aj), got=(q, aux),
                residuals=residuals, variant=variant)


def test_split01_two_steps(two_steps):
    """Every lane of both states and both auxes after 2 slow steps."""
    q, aux = two_steps["got"]
    qj, aj = two_steps["ref"]
    assert_pairs_close(q, aux, qj, aj, tol=STEP_TOL)
    assert all(bool(torch.isfinite(x).all()) for x in q + aux)


def test_split01_aux_lanes(two_steps):
    """The split01 lanes one by one, each nonzero where the reference is,
    and the 3-D coupling lanes."""
    q, aux = two_steps["got"]
    qj, aj = two_steps["ref"]
    m2 = two_steps["s"]["d2"].balance_law
    m3 = two_steps["s"]["d3"].balance_law
    for m, got, ref, names in ((m2, aux[1], aj[1], SPLIT01_AUX),
                               (m3, aux[0], aj[0], ("dGu", "ud", "w", "pkin",
                                                    "wz0"))):
        for name in names:
            sl = m.aux_spec.index(name)
            r = np.asarray(ref)[..., sl]
            assert np.abs(r).max() > 0, name
            assert max(rel_err_per_var(nm(got)[..., sl], r)) < STEP_TOL, name


def test_split01_gmres_residuals(two_steps):
    """Two steps of 5 IVDC solves, each ‖b − Lx‖/‖b‖ below 1e-10."""
    res = two_steps["residuals"]
    assert len(res) == 2 * IMPL
    assert max(res) < GMRES_TOL


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_split01_windows(variant):
    """The fast windows of each stage from the JAX loop's arithmetic
    (split_explicit.py:262-275 and :414-433) at the Julia dts and at the
    test's."""
    import math
    add, _, pmethod = VARIANTS[variant]

    class Model:
        add_fast_substeps = add

    class Dg:
        balance_law = Model()

    for dt, fdt in ((DT, DT_FAST), (5400.0, 240.0), (2400.0, 120.0)):
        slow = pmethod(None, dt)
        st = pse.SplitExplicitSolver.__new__(pse.SplitExplicitSolver)
        st.slow, st.dt, st.fast_dt, st.variant = slow, dt, fdt, variant
        st.nstages, st.dg3 = slow.nstages, Dg()
        expected = []
        if variant == "split01":
            C = slow.C
            for s in range(slow.nstages):
                gamma = (1.0 - C[s]) if s == slow.nstages - 1 else \
                    (C[s + 1] - C[s])
                steps = max(int(-(-(gamma * dt) // fdt // add)), 1)
                expected.append(((add - 1) * steps, add * steps,
                                 (add + 1) * steps))
        else:
            nts = 12 * max(math.ceil(dt / fdt / 12.0), 1)
            W, C = slow.RKW, slow.RKC
            for s in range(slow.nstages):
                fract = 1.0 - W[0] if s == slow.nstages - 1 else C[s + 1]
                steps = max(math.ceil(fract * dt / (dt / nts)), 1)
                addc = min(nts // add, steps - 1)
                k_save = steps if s == slow.nstages - 1 else 0
                if s == 0:
                    k_save = int(round(nts * W[0]))
                expected.append((steps - addc, k_save, steps + addc))
        assert [w[:3] for w in st.windows()] == expected
        assert st.fast_steps() == [e[2] for e in expected]


def _jax_batched(op, b, **kw):
    return jit_solvers.batched_gmres(op, jnp.asarray(b), **kw)


@pytest.mark.parametrize("case", ["many_systems", "batch_dependent"])
def test_batched_gmres(case):
    """tests/test_iterative_solvers.py:34 (16 systems of 12, Krylov 12)
    and :123 (8 of 10, per-batch coefficients, 2 restarts)."""
    if case == "many_systems":
        rng = np.random.RandomState(2)
        B, n, kw = 16, 12, dict(n_krylov=12)
        As = np.stack([np.eye(n) + 0.2 * rng.randn(n, n) for _ in range(B)])
    else:
        rng = np.random.RandomState(7)
        B, n, kw = 8, 10, dict(n_krylov=10, restarts=2)
        As = np.stack([np.eye(n) + 0.15 * rng.randn(n, n)
                       for _ in range(B)])
    bs = rng.randn(B, n)
    Aj, At = jnp.asarray(As), torch.as_tensor(As)
    xj, rj = _jax_batched(lambda x: jnp.einsum("bij,bj->bi", Aj, x), bs,
                          **kw)
    xt, rt = batched_gmres(lambda x: torch.einsum("bij,bj->bi", At, x),
                           torch.as_tensor(bs), **kw)
    assert rt.shape == (B,) and xt.shape == (B, n)
    assert float(rt.max()) < 1e-8
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                               atol=1e-12)
    expected = np.stack([np.linalg.solve(As[i], bs[i]) for i in range(B)])
    np.testing.assert_allclose(xt.numpy(), expected, rtol=0, atol=1e-6)


def test_batched_gmres_breakdown():
    """An operator 2·I, and a zero right-hand side in one row: the
    Arnoldi process breaks down after one step (zero columns in H); the
    host least squares gives the JAX function's minimum-norm answer."""
    rng = np.random.RandomState(3)
    bs = rng.randn(4, 6)
    bs[2] = 0.0
    xj, rj = _jax_batched(lambda x: 2.0 * x, bs, n_krylov=4)
    xt, rt = batched_gmres(lambda x: 2.0 * x, torch.as_tensor(bs),
                           n_krylov=4)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(xt.numpy(), bs / 2.0, rtol=0, atol=1e-14)
    assert float(rt.max()) < 1e-14
