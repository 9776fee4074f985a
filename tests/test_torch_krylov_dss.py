"""The port's iterative solvers (solvers/iterative.py) and direct
stiffness summation (mesh/dss.py) against the JAX package's, in float64
on the CPU, on the seeded systems of tests/test_iterative_solvers.py and
the grids of tests/test_dss_warps.py:

- CG on an SPD system, GCR(40) and restarted GCR(10) from an initial
  guess on a nonsymmetric one, Newton-Krylov on x³ + x − b = 0, GMRES
  with an initial guess and a right (Jacobi) preconditioner: each x
  within 1e-12 of JAX's (GCR 1e-11: its 40 A-orthogonalisations amplify
  round-off on this system), the residuals as small as JAX's;
- GMRES(3) on the backward-Euler system of the vertical acoustic-gravity
  operator (n_horz=2, n_vert=2, p3, α = 20), preconditioned by
  ``ColumnwiseLUPreconditioner`` on the dense column solver: relative
  residual below 1e-10, as JAX's, and x within 1e-10 of JAX's;
- the DSS map's groups, ``sum`` and the weighted and arithmetic
  ``average`` on a brick and a stacked cubed sphere, against JAX on the
  JAX grid's arrays (1e-14), with the JAX test's continuity,
  idempotence and fixed-point properties on the port's own grids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.atmos.linear import \
    AtmosAcousticGravityLinearModel as JaxLinear
from climatemachine_tpu.dg.spatial import VERTICAL
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.mesh import topology as jtopo
from climatemachine_tpu.mesh.dss import DSSMap as JaxDSSMap
from climatemachine_tpu.mesh.grid import make_grid as jax_make_grid
from climatemachine_tpu.solvers import columnwise as jcol
from climatemachine_tpu.solvers import iterative as J
from climatemachine_tpu_torch.atmos.linear import \
    AtmosAcousticGravityLinearModel
from climatemachine_tpu_torch.dg.spatial import DGModel
from climatemachine_tpu_torch.interop import (grid_from_numpy, grid_to_numpy,
                                              to_var_major)
from climatemachine_tpu_torch.mesh import topology
from climatemachine_tpu_torch.mesh.dss import DSSMap, dss
from climatemachine_tpu_torch.mesh.grid import make_grid
from climatemachine_tpu_torch.solvers import iterative as T
from climatemachine_tpu_torch.solvers.columnwise import (ColumnLayout,
                                                         ManyColumnSolver)
from numerics_parity import held_suarez_pair, one_torch_thread  # noqa: F401


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _mat(A, lib):
    return (lambda v: jnp.asarray(A) @ v) if lib is J else \
        (lambda v: t64(A) @ v)


# --- Krylov -----------------------------------------------------------------

def test_conjugate_gradient_matches_jax():
    rng = np.random.RandomState(3)
    n = 25
    Q = rng.randn(n, n)
    A = Q @ Q.T + n * np.eye(n)
    b = rng.randn(n)
    xj, rj = J.conjugate_gradient(_mat(A, J), jnp.asarray(b), n_iter=n)
    xt, rt = T.conjugate_gradient(_mat(A, T), t64(b), n_iter=n)
    assert float(rt) < 1e-7 and float(rj) < 1e-7
    assert np.abs(xt.numpy() - np.asarray(xj)).max() < 1e-12
    x0 = rng.randn(n)
    xj, _ = J.conjugate_gradient(_mat(A, J), jnp.asarray(b),
                                 x0=jnp.asarray(x0), n_iter=5)
    xt, _ = T.conjugate_gradient(_mat(A, T), t64(b), x0=t64(x0), n_iter=5)
    assert np.abs(xt.numpy() - np.asarray(xj)).max() < 1e-12


@pytest.mark.parametrize("kw", [dict(n_krylov=40),
                                dict(n_krylov=10, restarts=3, x0=True)],
                         ids=["gcr40", "gcr10x3_x0"])
def test_gcr_matches_jax(kw):
    rng = np.random.default_rng(3)
    A = np.eye(40) + 0.25 * rng.standard_normal((40, 40))
    b = rng.standard_normal(40)
    x0 = np.ones(40) if kw.pop("x0", False) else None
    xj, rj = J.generalized_conjugate_residual(
        _mat(A, J), jnp.asarray(b),
        x0=None if x0 is None else jnp.asarray(x0), **kw)
    xt, rt = T.generalized_conjugate_residual(
        _mat(A, T), t64(b), x0=None if x0 is None else t64(x0), **kw)
    assert np.abs(xt.numpy() - np.asarray(xj)).max() < 1e-11
    assert abs(float(rt) - float(rj)) <= 1e-11 * max(1.0, float(rj))
    if kw["n_krylov"] == 40:
        assert float(rt) < 1e-10
        assert np.allclose(xt.numpy(), np.linalg.solve(A, b), atol=1e-9)


def test_newton_krylov_matches_jax():
    b = np.linspace(-2, 2, 10)
    xj, rj = J.newton_krylov(lambda x: x ** 3 + x - jnp.asarray(b),
                             jnp.zeros(10), n_newton=8, n_krylov=10)
    rec = []
    xt, rt = T.newton_krylov(lambda x: x ** 3 + x - t64(b),
                             torch.zeros(10, dtype=torch.float64),
                             n_newton=8, n_krylov=10, record=rec)
    assert float(rt) < 1e-9 and float(rj) < 1e-9
    assert np.abs(xt.numpy() - np.asarray(xj)).max() < 1e-12
    assert len(rec) == 8 and rec[-1] < 1e-12


def test_newton_krylov_evaluations():
    """1 + n_krylov evaluations a Newton step, one for the residual."""
    calls = []

    def F(x):
        calls.append(1)
        return x ** 3 + x - 1.0

    T.newton_krylov(F, torch.zeros(6, dtype=torch.float64), n_newton=3,
                    n_krylov=4)
    assert len(calls) == 3 * (1 + 4) + 1


@pytest.mark.parametrize("solver", ["gmres", "newton_krylov"])
def test_nonfinite_system(solver):
    """A non-finite system stops GMRES with an error; Newton-Krylov
    carries it on as NaN, as the JAX function's lstsq does."""
    b = torch.full((6,), float("nan"), dtype=torch.float64)
    if solver == "gmres":
        with pytest.raises(np.linalg.LinAlgError):
            T.gmres(lambda v: 2.0 * v, b, n_krylov=3)
        return
    x, r = T.newton_krylov(lambda x: x - b, torch.zeros_like(b),
                           n_newton=2, n_krylov=3)
    xj, rj = J.newton_krylov(lambda x: x - jnp.asarray(b.numpy()),
                             jnp.zeros(6), n_newton=2, n_krylov=3)
    assert torch.isnan(x).all() and np.isnan(np.asarray(xj)).all()
    assert torch.isnan(r) and np.isnan(float(rj))


def test_gmres_x0_and_precond_match_jax():
    rng = np.random.RandomState(1)
    n = 40
    A = np.eye(n) + 0.3 * rng.randn(n, n) / np.sqrt(n)
    b, x0 = rng.randn(n), rng.randn(n)
    P = np.diag(1.0 / np.diag(A))
    xj, rj = J.gmres(_mat(A, J), jnp.asarray(b), x0=jnp.asarray(x0),
                     n_krylov=8, restarts=2, precond=_mat(P, J))
    xt, rt = T.gmres(_mat(A, T), t64(b), x0=t64(x0), n_krylov=8,
                     restarts=2, precond=_mat(P, T))
    assert np.abs(xt.numpy() - np.asarray(xj)).max() < 1e-12
    assert abs(float(rt) - float(rj)) < 1e-12
    assert T.NoPreconditioner()(xt) is xt


@pytest.fixture(scope="module")
def be_system():
    """The backward-Euler system of the vertical acoustic-gravity operator
    at n_horz=2, n_vert=2, p3 (tests/test_iterative_solvers.py:90-123),
    its right-hand side from a seeded generator, and JAX's preconditioned
    GMRES solution (compiled as a whole: step by step, each of its
    operations dispatched eagerly, it ran 30× slower under pytest's
    workers than alone; the state from the port's init,
    tests/numerics_parity.py)."""
    p = held_suarez_pair(0, size=dict(n_horz=2, n_vert=2, poly_order=3),
                         hyperdiffusion_tau=None)
    cfg_j, q = p["cfg_j"], jnp.asarray(p["q0"])
    aux = jnp.asarray(p["aux0"])
    lin_j = JaxDGModel(JaxLinear(cfg_j.model), cfg_j.grid,
                       direction=VERTICAL, update_aux=False)
    op_j = jax.jit(lambda x: lin_j(x, aux, 0.0)[0])
    col_j = jcol.ManyColumnSolver(op_j, jcol.ColumnLayout(
        cfg_j.grid, cfg_j.model.prog_spec.num), q)
    alpha = 20.0
    b = np.random.RandomState(0).randn(*q.shape)
    pre_j = J.ColumnwiseLUPreconditioner(col_j, alpha)
    xj, rj = jax.jit(lambda rhs: J.gmres(
        lambda v: (v.reshape(q.shape) - alpha * op_j(v.reshape(q.shape))
                   ).reshape(-1), rhs, n_krylov=3,
        precond=lambda v: pre_j(v).reshape(-1)))(jnp.asarray(b).reshape(-1))
    return dict(p, alpha=alpha, b=b, xj=xj,
                rj=float(rj) / np.linalg.norm(b))


def test_columnwise_lu_preconditioned_gmres_matches_jax(be_system):
    s = be_system
    q, aux = s["q0_t"], s["aux0_t"]
    lin = DGModel(AtmosAcousticGravityLinearModel(s["cfg_t"].model),
                  s["grid_t"], direction="vertical", update_aux=False)
    op = lambda x: lin(x, aux, 0.0)[0]
    col = ManyColumnSolver(op, ColumnLayout(s["grid_t"], 5), q)
    alpha = s["alpha"]
    pre = T.ColumnwiseLUPreconditioner(col, alpha)
    assert list(col._cached) == [alpha]          # factored once, kept
    b = to_var_major(s["b"], "cpu")
    x, r = T.gmres(lambda v: (v.reshape(q.shape) - alpha * op(
        v.reshape(q.shape))).reshape(-1), b.reshape(-1), n_krylov=3,
        precond=pre)
    rel = float(r) / float(torch.linalg.vector_norm(b))
    assert rel < 1e-10 and s["rj"] < 1e-10, (rel, s["rj"])
    ref = to_var_major(np.asarray(s["xj"]).reshape(s["q0"].shape), "cpu")
    err = (x.reshape(q.shape) - ref).abs().max() / ref.abs().max()
    assert err < 1e-10, err


# --- DSS --------------------------------------------------------------------

def _jax_grid(mesh):
    if mesh == "brick":
        t = jtopo.brick_topology([np.linspace(0, 1, 4)] * 3,
                                 periodicity=(False, False, False),
                                 boundary=np.ones((3, 2), dtype=int))
    else:
        t = jtopo.stacked_cubed_sphere_topology(2, np.linspace(1, 1.4, 3))
    return jax_make_grid(t, 3, dtype=np.float64)


def _port_grid(mesh):
    if mesh == "brick":
        t = topology.brick_topology([np.linspace(0, 1, 4)] * 3,
                                    periodicity=(False, False, False))
    else:
        t = topology.stacked_cubed_sphere_topology(2, np.linspace(1, 1.4, 3))
    return make_grid(t, 3, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("mesh", ["brick", "sphere"])
def test_dss_matches_jax(mesh):
    gj = _jax_grid(mesh)
    gt = grid_from_numpy(grid_to_numpy(gj), device="cpu",
                         dtype=torch.float64)
    mj, mt = JaxDSSMap(gj), DSSMap(gt)
    assert mt.num_segments == mj.num_segments
    assert np.array_equal(mt.gid.numpy(), np.asarray(mj.gid))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((gt.nelem, gt.Np, 3))        # node-major
    xt = to_var_major(x, "cpu")
    for got, ref in ((mt.sum(xt), mj.sum(jnp.asarray(x))),
                     (mt.average(xt), mj.average(jnp.asarray(x))),
                     (mt.average(xt, weighted=False),
                      mj.average(jnp.asarray(x), weighted=False)),
                     (dss(gt, xt), mj.average(jnp.asarray(x)))):
        ref = to_var_major(np.asarray(ref), "cpu")
        assert (got - ref).abs().max() < 1e-14 * ref.abs().max()


@pytest.mark.parametrize("mesh", ["brick", "sphere"])
def test_dss_projects_on_the_ports_grid(mesh):
    g = _port_grid(mesh)
    m = DSSMap(g)
    rng = np.random.default_rng(0)
    jump = torch.tensor(rng.random((g.nelem, 1, 1))).expand(g.nelem, 2,
                                                             g.Np)
    y = m.average(jump)
    groups = [m.gid == k for k in range(0, m.num_segments, 7)]
    flat = y.transpose(1, 2).reshape(-1, 2)
    for sel in groups:
        assert torch.allclose(flat[sel], flat[sel][0], atol=1e-12)
    assert (m.average(y) - y).abs().max() < 1e-12
    c = g.coords.transpose(1, 2)
    smooth = torch.sin(c[:, :1]) * torch.cos(c[:, 1:2])
    smooth = torch.cat([smooth, smooth], dim=1)
    assert (m.average(smooth) - smooth).abs().max() < 1e-10
    assert m.sum(torch.ones_like(jump)).min() >= 1.0
    assert m.count.sum() == g.nelem * g.Np
