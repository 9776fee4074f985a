"""The IMEX step with every ARK tableau (ode/ark.py) through the port's
``IMEXSolverType(solver_method=...).make``, against the JAX package's
step with the same tableau, in float64 on the CPU at n_horz=2, n_vert=3,
p3 with DryBiharmonic(8 h) and the every-step filter, from a seeded
perturbation of the initial state with seeded winds of 1 m/s, on
the var-major RHS and the banded column solver's block loop:

- one step per tableau at dt = 0.01 of the horizontal acoustic limit
  (vertical acoustic Courant number 3.6): 1e-10 of each variable's
  max|q| (measured ≤ 5.4e-12, on ρu).  The column solve mixes ρe's
  round-off, ~1e4, into ρu (tests/test_torch_imex.py), amplified by the
  conditioning of I − γ·dt·L: at 0.1 of the limit (Courant 36) the same
  steps differ by up to 3e-10 of ρu's max, 2e-14 of the state's, and
  from the state at rest, where ρu is one step's growth, by 1.5e-9 of
  ρu's max, hence the winds and this dt;
- the stage algebra's launches, counted on the CPU by wrapping the RHS
  and the layout conversions: an s-stage tableau calls the RHS s times,
  ``to_blocks`` s times and ``from_blocks`` s − 1 times a step (the
  launch counts chip_smoke.py predicts for rows 1, 3-8 and 9, 10);
- the dense column solver's grid-layout loop (``_step_impl`` on the
  fused remainder) against the banded block loop: the same step within
  1e-10 relative, for every tableau (zero and negative weights, a first
  stage with no implicit part, the full-RHS cancellation).

The JAX step runs its stage code eagerly around its var-major RHS, block
solve and apply, layout conversions, each compiled once (a jitted JAX
step compiles for each tableau); its column solver and var-major RHS are
built as the JAX type's ``make`` builds them, with the vertical operator
it probes compiled.  Both start from the port's initial state
(tests/numerics_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.atmos.linear import AtmosAcousticGravityLinearModel
from climatemachine_tpu.dg import fast_rhs as jax_fast_rhs
from climatemachine_tpu.dg.spatial import VERTICAL
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.experiments.held_suarez import \
    HeldSuarezStepFilter as JaxHeldSuarezStepFilter
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu.ode import ark as jark
from climatemachine_tpu.solvers import columnwise as jcol
from climatemachine_tpu_torch.driver.solver_types import IMEXSolverType
from climatemachine_tpu_torch.experiments.held_suarez import \
    HeldSuarezStepFilter
from climatemachine_tpu_torch.ode import ark
from numerics_parity import held_suarez_pair, one_torch_thread  # noqa: F401
TABLEAUS = ["ARK1ForwardBackwardEuler", "ARK2ImplicitExplicitMidpoint",
            "ARK548L2SA2KennedyCarpenter", "ARK437L2SA1KennedyCarpenter",
            "DBM453VoglEtAl"]
STAGES = {"ARK1ForwardBackwardEuler": 2, "ARK2ImplicitExplicitMidpoint": 2,
          "ARK548L2SA2KennedyCarpenter": 8, "ARK437L2SA1KennedyCarpenter": 7,
          "DBM453VoglEtAl": 5}
STEP_TOL = 1e-10


@pytest.fixture(scope="module")
def s():
    p = held_suarez_pair(31)
    cfg_j, dg_j, q0, aux0 = p["cfg_j"], p["dg_j"], p["q0"], p["aux0"]
    dt = 0.01 * jax_min_node_distance(cfg_j.grid, "horizontal") / 350.0
    # the JAX IMEX type's var-major pieces, built as its make builds them
    # (JAX solver_types.py:122-170) with the vertical operator compiled:
    # its make probes it eagerly, ~12 s
    lin = JaxDGModel(AtmosAcousticGravityLinearModel(cfg_j.model),
                     cfg_j.grid, numerical_flux_first_order=dg_j.nf1,
                     direction=VERTICAL, update_aux=False)
    layout = jcol.ColumnLayout(cfg_j.grid, cfg_j.model.prog_spec.num)
    cs = jcol.BlockTridiagColumnSolver(
        jax.jit(lambda x: lin(x, jnp.asarray(aux0), 0.0)[0]), layout,
        jnp.asarray(q0))
    cs.state_layout = jcol.VMColumnLayout(layout)
    vm = jax_fast_rhs.VarMajorRHS(dg_j)
    vm.thermo_writes_aux = False
    cs.solve_blocks = jax.jit(cs.solve_blocks, static_argnums=(1,))
    cs.apply_op_blocks = jax.jit(cs.apply_op_blocks)
    lay = cs.state_layout
    for name in ("to_blocks", "from_blocks"):
        setattr(lay, name, jax.jit(getattr(lay, name)))
    filt_j = jax.jit(JaxHeldSuarezStepFilter(cfg_j.grid,
                                             cfg_j.model).apply_vm)
    qv, auxv = vm.to_vm(jnp.asarray(p["q"])), vm.aux_to_vm(aux0)
    made = {kind: IMEXSolverType(solver_method=ark.DBM453VoglEtAl, **kw).make(
        p["dg_t"], p["q0_t"], p["aux0_t"], dt) for kind, kw in (
            ("banded", {}), ("dense", dict(columnwise_solver="dense")))}
    return dict(dt=dt, cs=cs, rhs_j=jax.jit(vm.__call__), filt_j=filt_j,
                qv=qv, auxv=auxv, qt=p["qt"], auxt=p["auxt"], made=made,
                filt_t=HeldSuarezStepFilter(p["grid_t"],
                                            p["cfg_t"].model).apply_vm)


def _jax_step(s, name):
    sol = getattr(jark, name)(None, None, s["cs"], s["dt"])
    sol.rhs_full = s["rhs_j"]
    sol.post_step = s["filt_j"]
    sol._jit_impl = sol._step_impl
    return np.asarray(sol.step(s["qv"], s["auxv"], 0.0)[0])


def _port(s, name, kind="banded"):
    """The tableau on the pieces ``IMEXSolverType(solver_method=
    DBM453VoglEtAl).make`` built (``kind``: "banded" or "dense"), as
    ``make`` passes them to any tableau: f_ex (the fused remainder, on
    the dense solver's loop), f_im, the column solver, ``rhs_full`` (the
    var-major RHS, on the banded block loop)."""
    m = s["made"][kind]
    sol = getattr(ark, name)(m.rhs_ex, m.rhs_im, m.solver, s["dt"],
                             rhs_full=m.rhs_full,
                             post_step=s["filt_t"])
    sol.vm = m.vm
    return sol


@pytest.mark.parametrize("kind", ["banded", "dense"])
def test_make_prefactorizes_its_gamma(s, kind):
    m = s["made"][kind]
    assert isinstance(m, ark.AdditiveRungeKutta) and m.nstages == 5
    assert list(m.solver._cached) == [m.A_im[1, 1] * s["dt"]]
    assert (m.vm is None) == (kind == "dense")
    assert (m.rhs_full is None) == (kind == "dense")


def _rel_per_var(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return (np.abs(got - ref).max(axis=(0, 2))
            / np.abs(ref).max(axis=(0, 2)))


@pytest.mark.parametrize("name", TABLEAUS)
def test_imex_step_matches_jax(s, name):
    sol = _port(s, name)
    assert sol.vm is not None and sol.nstages == STAGES[name]
    q1, _ = sol.step(s["qt"], s["auxt"], 0.0)
    err = _rel_per_var(q1.numpy(), _jax_step(s, name))
    assert err.max() < STEP_TOL, err


@pytest.mark.parametrize("name", TABLEAUS)
def test_stage_counts(s, name):
    sol = _port(s, name)
    lay = sol.solver.layout
    calls = {"rhs": 0, "to_blocks": 0, "from_blocks": 0}

    def counted(key, fn):
        def f(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return f

    sol.rhs_full = counted("rhs", sol.rhs_full)
    for key in ("to_blocks", "from_blocks"):
        setattr(lay, key, counted(key, getattr(lay, key)))
    sol.step(s["qt"], s["auxt"], 0.0)
    n = STAGES[name]
    assert calls == {"rhs": n, "to_blocks": n, "from_blocks": n - 1}


@pytest.mark.parametrize("name", TABLEAUS)
def test_dense_loop_matches_block_loop(s, name):
    blocks = _port(s, name)
    dense = _port(s, name, "dense")
    assert dense.rhs_full is None
    ref, _ = blocks.step(s["qt"], s["auxt"], 0.0)
    got, _ = dense.step(s["qt"], s["auxt"], 0.0)
    assert _rel_per_var(got.numpy(), ref.numpy()).max() < STEP_TOL
