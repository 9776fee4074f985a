"""The port's IMEX slice against the JAX package, in float64 on the CPU at
n_horz=2, n_vert=4, p3 (96 elements, 4 vertical elements so the period-3
comb probes two elements at once), with DryBiharmonic(8 h) and the
every-step filter:

- the grid↔column-block layouts (the plain versions of the layout
  kernels) against JAX ``to_blocks_vm``/``from_blocks_vm`` in interpret
  mode and JAX ``VMColumnLayout``, and the column layout against JAX
  ``ColumnLayout``: exactly equal; the round trip exact;
- the vertical linear DG operator (acoustic-gravity and acoustic)
  against JAX ``DGModel(lin, grid, direction=VERTICAL,
  update_aux=False)``: 1e-12 relative per variable (the two order their
  sums differently, in float64);
- the assembled operator: ``b_cols`` zero in both, the same active
  unknowns, L/D/U within 1e-12 of their largest entry (the port stores
  them ``[nv, ncol, i, j]``, JAX ``[nv, j, i, ncol]``);
- ``solve_blocks`` and ``apply_op_blocks`` at α = 0.3, 2.0, 25.0 against
  JAX's, 1e-10 relative (the solve amplifies the operators' round-off
  by the condition number of I − αL), with the backward-Euler residual
  below 1e-9 of the right-hand side and the dense ManyColumnSolver
  oracle within 1e-9, as tests/test_imex.py:54-81 hold the JAX solver;
- the wide-stencil refusal (tests/test_imex.py:84-98) and the inactive-
  unknown compression against the dense oracle;
- one and three ARK2GKC steps of the port's ``IMEXSolverType().make``
  against JAX's var-major IMEX step, with the filter: per variable,
  5e-12 of the state's largest magnitude.  The column solve mixes the
  variables of a column, so round-off of ρe (~3e4) lands on ρu (~1),
  and the column systems amplify it: on a state-like right-hand side
  the port's and JAX's solves leave the same backward-Euler residual
  (2.5e-14 of max|x|) yet differ by 8.6e-13 of max|x|, their pivot
  inverses by 9e-14.  Measured after one and three steps: 5.2e-13 and
  4.9e-13 of max|q| (ρe), 3e-15 on ρu; JAX's own var-major and grid
  steps, which share one factorization, differ by 2e-16
  (tests/test_fast_rhs.py:122-123 holds them at 5e-12 of each
  variable).

The JAX solver is built once for the module (its ``make`` compiles the
probing map, ~20 s on a CPU); both packages read the JAX grid's arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.atmos import linear as jax_linear
from climatemachine_tpu.dg.spatial import VERTICAL
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init_ode_state
from climatemachine_tpu.driver.solver_types import \
    IMEXSolverType as JaxIMEXSolverType
from climatemachine_tpu.experiments.held_suarez import \
    HeldSuarezStepFilter as JaxHeldSuarezStepFilter
from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu.solvers import columnwise as jax_columnwise
from climatemachine_tpu.solvers.pallas_layout import (
    from_blocks_vm as jax_from_blocks_vm, to_blocks_vm as jax_to_blocks_vm)
from climatemachine_tpu_torch.atmos import linear
from climatemachine_tpu_torch.dg.fast_rhs import VarMajorRHS
from climatemachine_tpu_torch.dg.spatial import DGModel
from climatemachine_tpu_torch.driver.solver_types import IMEXSolverType
from climatemachine_tpu_torch.experiments.held_suarez import (
    HeldSuarezStepFilter, held_suarez_config)
from climatemachine_tpu_torch.interop import (grid_from_numpy,
                                              grid_to_numpy,
                                              state_from_numpy)
from climatemachine_tpu_torch.ode.ark import ARK2GiraldoKellyConstantinescu
from climatemachine_tpu_torch.solvers import layout_kernel
from climatemachine_tpu_torch.solvers.columnwise import (
    BlockTridiagColumnSolver, ColumnLayout, ManyColumnSolver)

SIZE = dict(n_horz=2, n_vert=4, poly_order=3)
ALPHAS = [0.3, 2.0, 25.0]
LINEAR = ["AtmosAcousticGravityLinearModel", "AtmosAcousticLinearModel"]


@pytest.fixture(scope="module")
def setup():
    """JAX config, its initial state perturbed from a seeded numpy
    generator, the JAX var-major IMEX solver with the filter and its
    states after one and three steps; the port's model on the JAX grid's
    arrays and its IMEX solver."""
    cfg_j = jax_held_suarez_config(dtype=np.float64, **SIZE)
    dg_j = JaxDGModel(cfg_j.model, cfg_j.grid)
    q0, aux0 = jax_init_ode_state(dg_j)
    rng = np.random.default_rng(11)
    q = np.asarray(q0) * (1 + 1e-3 * rng.standard_normal(q0.shape))
    dt = 0.1 * jax_min_node_distance(cfg_j.grid, "horizontal") / 350.0

    imex_j = JaxIMEXSolverType().make(dg_j, q0, aux0, dt)
    imex_j.post_step = JaxHeldSuarezStepFilter(cfg_j.grid,
                                               cfg_j.model).apply_vm
    vm = imex_j.vm
    qv, auxv = vm.to_vm(jnp.asarray(q)), vm.aux_to_vm(aux0)
    steps_j = {}
    for i in range(3):
        qv, auxv = imex_j.step(qv, auxv, i * dt)
        steps_j[i + 1] = np.asarray(qv)

    cfg_t = held_suarez_config(dtype=torch.float64, device="cpu", **SIZE)
    grid_t = grid_from_numpy(grid_to_numpy(cfg_j.grid), device="cpu",
                             dtype=torch.float64)
    dg_t = DGModel(cfg_t.model, grid_t)
    q0_t, aux0_t = state_from_numpy(q0, aux0, device="cpu")
    imex_t = IMEXSolverType().make(dg_t, q0_t, aux0_t, dt)
    imex_t.post_step = HeldSuarezStepFilter(grid_t, cfg_t.model).apply_vm
    return dict(cfg_j=cfg_j, dg_j=dg_j, q0=q0, aux0=aux0, q=q, dt=dt,
                imex_j=imex_j, steps_j=steps_j, cfg_t=cfg_t, grid_t=grid_t,
                dg_t=dg_t, q0_t=q0_t, imex_t=imex_t)


def _rel_err_per_var(got_vm, ref_vm):
    """max |got − ref| per variable over elements and nodes, relative to
    max |ref| of that variable; both var-major [E, n, Np]."""
    got, ref = np.asarray(got_vm), np.asarray(ref_vm)
    scale = np.maximum(np.max(np.abs(ref), axis=(0, 2)), 1e-300)
    return np.max(np.abs(got - ref), axis=(0, 2)) / scale


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)


def _random(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


# --- layouts -----------------------------------------------------------------

@pytest.fixture(scope="module")
def layouts(setup):
    g = setup["cfg_j"].grid
    lay_j = jax_columnwise.ColumnLayout(g, 5)
    return (lay_j, jax_columnwise.VMColumnLayout(lay_j, use_pallas=False),
            ColumnLayout(setup["grid_t"], 5))


def test_layout_dims_match_jax(layouts):
    lay_j, vm_j, lay_t = layouts
    assert lay_t.layout_dims == vm_j._dims
    assert (lay_t.ncol, lay_t.Nv, lay_t.n_horz, lay_t.n_vert) == \
        (lay_j.ncol, lay_j.Nv, lay_j.n_horz, lay_j.n_vert)


def test_to_blocks_plain_matches_jax(layouts):
    _, vm_j, lay_t = layouts
    E, Np = lay_t.n_horz * lay_t.n_vert, lay_t.Np
    x = _random((E, 5, Np), 1)
    got = layout_kernel.to_blocks_vm_plain(torch.tensor(x), lay_t.layout_dims)
    np.testing.assert_array_equal(got.numpy(), np.asarray(vm_j.to_blocks(x)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_to_blocks_vm(
        jnp.asarray(x), layout_dims=vm_j._dims, interpret=True)))
    # the wrapper takes the plain version on the CPU
    np.testing.assert_array_equal(lay_t.to_blocks(torch.tensor(x)).numpy(),
                                  got.numpy())


def test_from_blocks_plain_matches_jax(layouts):
    _, vm_j, lay_t = layouts
    y = _random((lay_t.n_vert, lay_t.Nq[2] * 5, lay_t.ncol), 2)
    got = layout_kernel.from_blocks_vm_plain(torch.tensor(y),
                                             lay_t.layout_dims)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(vm_j.from_blocks(y)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_from_blocks_vm(
        jnp.asarray(y), layout_dims=vm_j._dims, interpret=True)))
    np.testing.assert_array_equal(lay_t.from_blocks(torch.tensor(y)).numpy(),
                                  got.numpy())


def test_block_round_trip_exact(layouts):
    _, _, lay_t = layouts
    x = torch.tensor(_random((lay_t.n_horz * lay_t.n_vert, 5, lay_t.Np), 3))
    assert torch.equal(lay_t.from_blocks(lay_t.to_blocks(x)), x)
    assert torch.equal(lay_t.from_columns(lay_t.to_columns(x)), x)


def test_columns_match_jax(layouts):
    """Var-major columns equal the JAX node-major layout's columns."""
    lay_j, _, lay_t = layouts
    x = _random((lay_t.n_horz * lay_t.n_vert, 5, lay_t.Np), 4)
    xc = lay_t.to_columns(torch.tensor(x))
    np.testing.assert_array_equal(
        xc.numpy(), np.asarray(lay_j.to_columns(x.transpose(0, 2, 1))))
    np.testing.assert_array_equal(
        lay_t.from_columns(xc).numpy().transpose(0, 2, 1),
        np.asarray(lay_j.from_columns(xc.numpy())))


# --- the vertical linear operator ----------------------------------------------

@pytest.mark.parametrize("name", LINEAR)
def test_vertical_linear_operator_matches_jax(setup, name):
    lin_j = getattr(jax_linear, name)(setup["cfg_j"].model)
    dg_lin_j = JaxDGModel(lin_j, setup["cfg_j"].grid, direction=VERTICAL,
                          update_aux=False)
    ref, _ = dg_lin_j(jnp.asarray(setup["q"]), setup["aux0"], 0.0)
    lin_t = getattr(linear, name)(setup["cfg_t"].model)
    dg_lin_t = DGModel(lin_t, setup["grid_t"], direction="vertical",
                       update_aux=False)
    qv, auxv = state_from_numpy(setup["q"], setup["aux0"], device="cpu")
    got, aux = dg_lin_t(qv, auxv, 0.0)
    assert aux is auxv
    err = _rel_err_per_var(got, np.asarray(ref).transpose(0, 2, 1))
    assert err.max() < 1e-12, err


# --- the assembled operator, solve and apply ------------------------------------

def test_operator_blocks_match_jax(setup):
    sj, st = setup["imex_j"].solver, setup["imex_t"].solver
    assert float(jnp.max(jnp.abs(sj.b_cols))) == 0.0
    assert float(st.b_cols.abs().max()) == 0.0
    np.testing.assert_array_equal(st._sel.numpy(), np.asarray(sj._sel))
    assert st.active_count == len(sj._sel) <= st.nb
    for got, ref in ((st.Lc, sj.Lc), (st.Dc, sj.Dc), (st.Uc, sj.Uc)):
        got = got.permute(0, 3, 2, 1)      # [nv, ncol, i, j] → JAX's layout
        assert tuple(got.shape) == ref.shape
        assert _rel_err(got.numpy(), ref) < 1e-12


@pytest.mark.parametrize("alpha", ALPHAS)
def test_solve_and_apply_match_jax(setup, alpha):
    sj, st = setup["imex_j"].solver, setup["imex_t"].solver
    lay = st.layout
    rhs = _random((lay.n_vert, st.nb, lay.ncol), 5)
    got = st.solve_blocks(torch.tensor(rhs), alpha)
    assert _rel_err(got.numpy(), sj.solve_blocks(jnp.asarray(rhs),
                                                 alpha)) < 1e-10
    applied = st.apply_op_blocks(torch.tensor(rhs))
    assert _rel_err(applied.numpy(), sj.apply_op_blocks(jnp.asarray(rhs))) \
        < 1e-12


@pytest.mark.parametrize("alpha", ALPHAS)
def test_solve_matches_dense_oracle(setup, alpha):
    """The banded solve against the dense basis-probed inverse, and the
    backward-Euler residual (I − αL) y − x, through the DG operator."""
    st = setup["imex_t"].solver
    dense = ManyColumnSolver(st.op, st.layout, setup["q0_t"])
    x = torch.tensor(_random((st.layout.n_horz * st.layout.n_vert, 5,
                              st.layout.Np), 6))
    y = st.solve(x, alpha)
    assert _rel_err(y, dense.solve(x, alpha)) < 1e-9
    resid = y - alpha * st.op(y) - x
    assert resid.abs().max() < 1e-9 * x.abs().max()
    Lx = dense.apply_op(x)
    assert _rel_err(st.apply_op(x), Lx) < 1e-11


def test_wide_stencil_refused(setup):
    lay = setup["imex_t"].solver.layout

    def wide(x):
        # a linear operator coupling element ev to ev − 2
        xb = lay.to_columns(x).reshape(lay.ncol, lay.n_vert, -1)
        yb = torch.roll(xb, 2, dims=1)
        return lay.from_columns(yb.reshape(lay.ncol, lay.Nv))

    with pytest.raises(ValueError, match="beyond adjacent"):
        BlockTridiagColumnSolver(wide, lay, setup["q0_t"])


def test_compressed_solve_matches_dense_oracle(setup):
    """With ρu[0] masked out of the operator's rows and columns the
    solver drops its Nq3 unknowns per block and still solves as the
    dense oracle does, inactive rows included (q = rhs there)."""
    st = setup["imex_t"].solver
    mask = torch.ones(5, 1, dtype=torch.float64)
    mask[1] = 0.0
    op = lambda x: mask * st.op(mask * x)
    q = setup["q0_t"]
    banded = BlockTridiagColumnSolver(op, st.layout, q)
    assert banded.active_count == st.nb - st.layout.Nq[2]
    dense = ManyColumnSolver(op, st.layout, q)
    x = torch.tensor(_random(tuple(q.shape), 7))
    for alpha in ALPHAS:
        assert _rel_err(banded.solve(x, alpha), dense.solve(x, alpha)) < 1e-9
    assert _rel_err(banded.apply_op(x), dense.apply_op(x)) < 1e-11


# --- the IMEX step -----------------------------------------------------------------

@pytest.mark.parametrize("nsteps", [1, 3])
def test_imex_steps_match_jax(setup, nsteps):
    imex, dt = setup["imex_t"], setup["dt"]
    q, aux = state_from_numpy(setup["q"], setup["aux0"], device="cpu")
    for i in range(nsteps):
        q, aux = imex.step(q, aux, i * dt)
    ref = setup["steps_j"][nsteps]
    err = np.max(np.abs(q.numpy() - ref), axis=(0, 2)) / np.abs(ref).max()
    assert err.max() < 5e-12, err


def test_split_step_matches_full_rhs_step(setup):
    """The ARK step with f_ex = full − vertical linear RHS (no rhs_full)
    against the rhs_full step: the same step up to round-off."""
    imex, dg_t, dt = setup["imex_t"], setup["dg_t"], setup["dt"]
    full = VarMajorRHS(dg_t, write_aux=False)
    dg_lin = DGModel(linear.AtmosAcousticGravityLinearModel(
        dg_t.balance_law), dg_t.grid, direction="vertical", update_aux=False)

    def rhs_ex(q, aux, t):
        f, aux = full(q, aux, t)
        return f - dg_lin(q, aux, t)[0], aux

    split = ARK2GiraldoKellyConstantinescu(rhs_ex, None, imex.solver, dt,
                                           post_step=imex.post_step)
    q, aux = state_from_numpy(setup["q"], setup["aux0"], device="cpu")
    ref, _ = imex.step(q, aux, 0.0)
    got, _ = split.step(q, aux, 0.0)
    assert _rel_err(got, ref) < 5e-12
