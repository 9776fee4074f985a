"""The SSPRK explicit steps and the HEVI and Implicit solver types of the
port against the JAX package's, in float64 on the CPU at n_horz=2,
n_vert=3, p3 with DryBiharmonic(8 h), from a seeded perturbation of the
JAX initial state with seeded winds of 1 m/s:

- one step of each SSPRK method through ``ExplicitSolverType(
  solver_method=...)`` on the var-major RHS ("auto") and SSPRK33 on the
  generic operator ("grid"), against the JAX method on the JAX generic
  operator: 1e-12 of each variable's max|q|; the port's explicit type
  refuses an SSPRK on the generic operator of a balance law whose
  ``preprocess_state`` is not the identity (the ocean box with its
  vertical filters), where the JAX type would drop it;
- two steps of ``HEVISolverType(nonlinear_max_iterations=3,
  linear_max_subspace_size=12)`` at 8 × the explicit dt and of
  ``ImplicitSolverType(n_newton=3, n_krylov=12)`` at 20 × (the settings
  of tests/test_solver_types.py): 1e-8 of each variable's max|q|.  The
  Newton-Krylov solves stop after a fixed count, unconverged, and their
  Jacobian-vector products are finite differences (ε = 1e-10·(‖x‖ + 1)
  in HEVI, 1e-7·(‖x‖ + 1) in Implicit) whose round-off, ~1e-16·‖F‖/ε of
  each product, differs between the packages' operation orders: after
  two steps they differ by 3.1e-9 (HEVI) and 6.6e-11 (Implicit) of a
  variable's max (with 2 Newton steps of GMRES(8), HEVI by 9.5e-7: the
  less converged, the more sensitive); the solves' residuals are
  recorded, one entry a solve with
  one GMRES residual a Newton step, and the final ‖F‖ matches JAX's
  within 1e-12 of ‖q‖ (‖F‖ is the small remainder of terms of ‖q‖'s
  size: 0.018 against ‖q‖ ≈ 4e6, where the two differ by 3e-7);
- the implicit paths' launches, counted on the CPU: per step HEVI
  evaluates the full operator 2 times and the vertical one 4 + n_newton
  · (1 + n_krylov) + 1 times, Implicit the full one n_newton ·
  (1 + n_krylov) + 2 times (chip_smoke.py's prediction of rows 2-6).

The JAX solvers step eagerly around their DG operators, each compiled
once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.spatial import VERTICAL
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.driver import solver_types as jst
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu.ode import ssprk as jssprk
from climatemachine_tpu.solvers import iterative as jiterative
from climatemachine_tpu_torch.dg.spatial import DGModel
from climatemachine_tpu_torch.driver import solver_types as st
from climatemachine_tpu_torch.experiments.ocean_box import ocean_box_config
from climatemachine_tpu_torch.interop import to_var_major
from climatemachine_tpu_torch.ode import ssprk
from numerics_parity import held_suarez_pair, one_torch_thread  # noqa: F401

SSPRK = ["SSPRK22Heuns", "SSPRK22Ralstons", "SSPRK33ShuOsher",
         "SSPRK34SpiteriRuuth"]
HEVI = dict(nonlinear_max_iterations=3, linear_max_subspace_size=12)
IMPLICIT = dict(n_newton=3, n_krylov=12)


@pytest.fixture(scope="module")
def s():
    out = held_suarez_pair(37)
    cfg_j, dg_j = out["cfg_j"], out["dg_j"]
    vdg_j = JaxDGModel(cfg_j.model, cfg_j.grid, direction=VERTICAL,
                       update_aux=False)
    out.update(q=jnp.asarray(out["q"]),
               rhs_j=jax.jit(lambda q, a, t: dg_j(q, a, t)),
               vrhs_j=jax.jit(lambda q, a, t: vdg_j(q, a, t)),
               dt=0.3 * jax_min_node_distance(cfg_j.grid) / 350.0)
    return out


def _rel_per_var(got, ref_node_major):
    ref = to_var_major(np.asarray(ref_node_major), "cpu").numpy()
    return (np.abs(got.numpy() - ref).max(axis=(0, 2))
            / np.abs(ref).max(axis=(0, 2)))


def _steps(solver, q, aux, n, dt):
    for i in range(n):
        q, aux = solver.step(q, aux, i * dt)
    return q


# --- SSPRK ------------------------------------------------------------------

@pytest.mark.parametrize("layout,name", [("auto", n) for n in SSPRK]
                         + [("grid", "SSPRK33ShuOsher")])
def test_ssprk_step_matches_jax(s, layout, name):
    ref = _steps(getattr(jssprk, name)(s["rhs_j"], s["dt"]), s["q"],
                 s["aux0"], 1, s["dt"])
    sol = st.ExplicitSolverType(solver_method=getattr(ssprk, name),
                                state_layout=layout).make(
        s["dg_t"], s["q0_t"], s["aux0_t"], s["dt"])
    assert (sol.vm is None) == (layout == "grid")
    got = _steps(sol, s["qt"], s["auxt"], 1, s["dt"])
    assert _rel_per_var(got, ref).max() < 1e-12


def test_ssprk_refuses_a_projecting_balance_law():
    dg, q0, aux0, _ = ocean_box_config(nelem=(2, 2, 2), polyorder=2,
                                       device="cpu")
    assert not dg.balance_law.preprocess_is_identity
    with pytest.raises(ValueError, match="pre_stage"):
        st.ExplicitSolverType(solver_method=ssprk.SSPRK33ShuOsher).make(
            dg, q0, aux0, 1.0)
    dg.balance_law.apply_vert_filters = False
    sol = st.ExplicitSolverType(solver_method=ssprk.SSPRK33ShuOsher).make(
        dg, q0, aux0, 1.0)
    assert sol.vm is None and sol.rhs is dg


# --- HEVI and Implicit ------------------------------------------------------

def _jax_hevi(s, dt):
    sol = jst.HEVISolverType(**HEVI).make(s["dg_j"], s["q0"], s["aux0"], dt)
    rhs_j, vrhs_j = s["rhs_j"], s["vrhs_j"]

    def rhs_ex(q, a, t):
        full, a = rhs_j(q, a, t)
        return full - vrhs_j(q, a, t)[0], a

    def rhs_im(q, a, t):
        return vrhs_j(q, a, t)[0], a

    sol.rhs_ex, sol.rhs_im, sol.solver.rhs_im = rhs_ex, rhs_im, rhs_im
    sol._jit_impl = sol._step_impl
    return sol


def _jax_implicit(s, dt):
    sol = jst.ImplicitSolverType(**IMPLICIT).make(s["dg_j"], s["q0"],
                                                  s["aux0"], dt)
    sol.rhs = s["rhs_j"]
    return sol


@pytest.fixture(scope="module")
def implicit_runs(s):
    """Two steps of each implicit type in both packages; the JAX
    Newton-Krylov final residuals recorded by wrapping its function."""
    out = {}
    for kind, jmake, pmake, ratio in (
            ("hevi", _jax_hevi, st.HEVISolverType(**HEVI), 8.0),
            ("implicit", _jax_implicit, st.ImplicitSolverType(**IMPLICIT),
             20.0)):
        dt = ratio * s["dt"]
        res_j = []
        nk = jiterative.newton_krylov

        def recording(*a, **k):
            x, r = nk(*a, **k)
            res_j.append(float(r))
            return x, r

        jiterative.newton_krylov = recording
        try:
            ref = _steps(jmake(s, dt), s["q"], s["aux0"], 2, dt)
        finally:
            jiterative.newton_krylov = nk
        sol = pmake.make(s["dg_t"], s["q0_t"], s["aux0_t"], dt)
        got = _steps(sol, s["qt"], s["auxt"], 2, dt)
        out[kind] = dict(ref=ref, got=got, sol=sol, res_j=res_j)
    return out


@pytest.mark.parametrize("kind", ["hevi", "implicit"])
def test_implicit_types_match_jax(implicit_runs, kind):
    r = implicit_runs[kind]
    err = _rel_per_var(r["got"], r["ref"])
    assert err.max() < 1e-8, err
    assert torch.isfinite(r["got"]).all()


@pytest.mark.parametrize("kind", ["hevi", "implicit"])
def test_implicit_residuals_recorded(implicit_runs, kind):
    r = implicit_runs[kind]
    sol = r["sol"]
    res = (sol.solver if kind == "hevi" else sol).residuals
    n_newton = HEVI["nonlinear_max_iterations"] if kind == "hevi" \
        else IMPLICIT["n_newton"]
    assert len(res) == len(r["res_j"]) == 2
    scale = float(torch.linalg.vector_norm(r["got"]))
    for (newton, gm), ref in zip(res, r["res_j"]):
        assert len(gm) == n_newton
        assert abs(float(newton) - ref) <= 1e-12 * scale, (newton, ref)


def test_implicit_operator_evaluations(s, monkeypatch):
    counts = {"full": 0, "vertical": 0}

    class Counting(DGModel):
        def __call__(self, q, aux, t):
            counts["vertical" if self.direction == "vertical"
                   else "full"] += 1
            return super().__call__(q, aux, t)

    monkeypatch.setattr(st, "DGModel", Counting)
    dg = Counting(s["dg_t"].balance_law, s["dg_t"].grid)
    dt = 8.0 * s["dt"]
    sol = st.HEVISolverType(**HEVI).make(dg, s["q0_t"], s["aux0_t"], dt)
    sol.step(s["qt"], s["auxt"], 0.0)
    n, k = HEVI["nonlinear_max_iterations"], HEVI["linear_max_subspace_size"]
    assert counts == {"full": 2, "vertical": 4 + n * (1 + k) + 1}
    counts.update(full=0, vertical=0)
    sol = st.ImplicitSolverType(**IMPLICIT).make(dg, s["q0_t"], s["aux0_t"],
                                                 dt)
    sol.step(s["qt"], s["auxt"], 0.0)
    n, k = IMPLICIT["n_newton"], IMPLICIT["n_krylov"]
    assert counts == {"full": n * (1 + k) + 2, "vertical": 0}

