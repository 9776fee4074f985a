"""The port's moist baroclinic wave with two passive tracers and warm
rain on the generic DG operator against the JAX package, in float64 on
the CPU at n_horz=2, n_vert=2, p3 on the JAX grid's arrays, from the
seeded state of tests/tracer_parity.py (nq = 9: ρ, ρu, ρe, ρq_tot,
ρq_rai, ρχ₁, ρχ₂):

- the prognostic and aux schemas, lane by lane by name, and the
  initial state of ``baroclinic_wave_config(tracers=...)``;
- the generic RHS ``DGModel(model, grid)(q, aux, t)`` per variable
  (RHS_TOL, the generic RHS's precedent) and the aux it refreshes (the
  saturation adjustment's lanes, 1e-11);
- the tracer masses: the RHS's tracer lanes integrate to zero;
- one step of each solver type's ``make``: ``ExplicitSolverType()``
  (1e-12 of max|q| per variable, tests/test_torch_grid_steps.py),
  ``IMEXSolverType()`` (banded) and ``IMEXSolverType(columnwise_solver=
  "dense")`` (5e-12, tests/test_torch_imex.py: the column solve mixes
  ρe's round-off into ρu) at dt = 0.01 of the horizontal acoustic CFL,
  the moist IMEX tests' (tests/test_torch_moist_imex.py);
- "auto" choosing the generic operator and "vm" raising, in both
  packages;
- NTracers' second-order hooks against JAX's on random inputs.

The JAX steps are JAX's own step code run eagerly with its RHS (the
full one, or the dense path's remainder) and, banded, the column
solver's block solve, block apply and layouts compiled one by one: a
jitted JAX step costs 13-25 s of compilation here.  The JAX set-up
check of the frozen operator is skipped; the port's runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_parity as tp

from climatemachine_tpu.atmos.model import AtmosModel as JaxAtmosModel
from climatemachine_tpu.dg import fast_rhs as jax_fast_rhs
from climatemachine_tpu.driver.solver_types import \
    ExplicitSolverType as JaxExplicitSolverType
from climatemachine_tpu.driver.solver_types import \
    IMEXSolverType as JaxIMEXSolverType
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu_torch.atmos.tracers import NoTracers, NTracers
from climatemachine_tpu_torch.dg import fast_rhs
from climatemachine_tpu_torch.dg.spatial import init_ode_state
from climatemachine_tpu_torch.driver.solver_types import (ExplicitSolverType,
                                                          IMEXSolverType)
from climatemachine_tpu_torch.interop import state_from_numpy, to_var_major
from climatemachine_tpu_torch.utils.variables import VarSpec

STEP_TOL = {"explicit": 1e-12, "imex": 5e-12, "dense": 5e-12}


@pytest.fixture(scope="module")
def s():
    """tracer_parity.setup() and the JAX RHS (jitted) at the test state."""
    out = tp.setup()
    out["rhs_j"] = tp.jit_rhs(out["dg_j"])
    dq, aux = out["rhs_j"](tp.as_jax(out["q"]), out["aux0"], 0.0)
    out.update(dq_ref=np.asarray(dq), aux_ref=np.asarray(aux))
    return out


def test_schema_matches_jax(s):
    mj, mt = s["model_j"], s["model_t"]
    assert mt.prog_spec.flattened_names() == mj.prog_spec.flattened_names()
    assert mt.prog_spec.flattened_names()[5:] == [
        "moisture.rhoq_tot", "precipitation.rhoq_rai", "tracers.rhochi[0]",
        "tracers.rhochi[1]"]
    assert mt.aux_spec.flattened_names() == mj.aux_spec.flattened_names()


def test_interop_checks_lane_names(s):
    mj = s["model_j"]
    names = mj.prog_spec.flattened_names()
    aux_names = mj.aux_spec.flattened_names()
    swapped = names[:6] + names[7:] + names[6:7]
    with pytest.raises(ValueError, match="prognostic lanes"):
        state_from_numpy(s["q"], s["aux0"], device="cpu",
                         model=s["model_t"], names=(swapped, aux_names))
    with pytest.raises(ValueError, match="aux lanes"):
        state_from_numpy(s["q"], s["aux0"], device="cpu",
                         model=s["model_t"], names=(names, aux_names[::-1]))


def test_initial_state_matches_jax(s):
    """``init_ode_state`` of the port's model: ρχ and ρq_rai zero, the
    rest the moist wave's, as the JAX package's."""
    q0, aux0 = init_ode_state(s["dg_t"])
    assert q0.shape[1] == 9 and not q0[:, 6:].any()
    assert tp.rel_err_per_var(q0, s["q0"])[:6].max() < 1e-12
    assert tp.rel_err_per_var(aux0, s["aux0"]).max() < 1e-12


def test_generic_rhs_matches_jax(s):
    qt, auxt = tp.port_state(s)
    dq, aux = s["dg_t"](qt, auxt, 0.0)
    err = tp.rel_err_per_var(dq, s["dq_ref"])
    assert dq.shape[1] == 9 and err.max() < tp.RHS_TOL, err
    assert tp.rel_err_per_var(aux, s["aux_ref"]).max() < 1e-11
    # the rain and both tracers move
    assert (dq[:, 6:].abs().amax(dim=(0, 2)) > 0).all()


def test_tracer_masses_conserved_by_rhs(s):
    """Σ M dρχ/dt = 0 to round-off: the tracers have no source, and the
    walls reflect u and copy ρχ."""
    qt, auxt = tp.port_state(s)
    dq, _ = s["dg_t"](qt, auxt, 0.0)
    M = s["dg_t"].grid.M[:, None]
    net = (M * dq[:, 7:]).sum(dim=(0, 2))
    gross = (M * dq[:, 7:].abs()).sum(dim=(0, 2))
    assert (net.abs() / gross).max() < 1e-12, net / gross


def _jax_step(s, kind, dt):
    """One step of the JAX solver made by ``kind``'s solver type, its RHS
    compiled (module docstring)."""
    if kind == "explicit":
        solver = JaxExplicitSolverType().make(s["dg_j"], s["q0"], s["aux0"],
                                              dt)
        assert solver.vm is None
        solver.rhs = s["rhs_j"]
    else:
        kw = dict(columnwise_solver="dense") if kind == "dense" else {}
        solver = JaxIMEXSolverType(check_frozen_operator=False, **kw).make(
            s["dg_j"], s["q0"], s["aux0"], dt)
        assert solver.vm is None
        if kind == "dense":
            solver.rhs_ex = jax.jit(solver.rhs_ex)
        else:
            solver.rhs_full = s["rhs_j"]
            cs = solver.solver
            cs.solve_blocks = jax.jit(cs.solve_blocks, static_argnums=(1,))
            cs.apply_op_blocks = jax.jit(cs.apply_op_blocks)
            for name in ("to_blocks", "from_blocks"):
                setattr(cs.layout, name, jax.jit(getattr(cs.layout, name)))
        solver._jit_impl = solver._step_impl
    return solver.step(tp.as_jax(s["q"]), s["aux0"], 0.0)[0]


@pytest.mark.parametrize("kind", ["explicit", "imex", "dense"])
def test_solver_step_matches_jax(s, kind):
    grid_j = s["cfg_j"].grid
    dt = (0.3 * jax_min_node_distance(grid_j) if kind == "explicit"
          else 0.01 * jax_min_node_distance(grid_j, "horizontal")) / 350.0
    q_ref = _jax_step(s, kind, dt)
    q0, aux0 = state_from_numpy(s["q0"], s["aux0"], device="cpu")
    if kind == "explicit":
        solver = ExplicitSolverType().make(s["dg_t"], q0, aux0, dt)
    else:
        solver = IMEXSolverType(**(dict(columnwise_solver="dense")
                                   if kind == "dense" else {})).make(
            s["dg_t"], q0, aux0, dt)
        assert solver.solver.layout.nvars == 9
        if kind == "imex":
            assert solver.rhs_full is s["dg_t"] and solver.solver.nb == 36
    assert solver.vm is None
    qt, auxt = tp.port_state(s)
    q1, _ = solver.step(qt, auxt, 0.0)
    ref = to_var_major(np.asarray(q_ref), "cpu").numpy()
    err = np.max(np.abs(q1.numpy() - ref), axis=(0, 2)) / np.abs(ref).max()
    assert err.max() < STEP_TOL[kind], err
    assert (q1[:, 7:] != qt[:, 7:]).any()


def test_auto_generic_and_vm_raises(s):
    """Tracers and rain: neither package's var-major RHS takes the model;
    "auto" gives the generic operator, "vm" raises."""
    dg_j, dg_t = s["dg_j"], s["dg_t"]
    q0, aux0 = state_from_numpy(s["q0"], s["aux0"], device="cpu")
    assert not jax_fast_rhs.supports(dg_j) and not fast_rhs.supports(dg_t)
    assert JaxExplicitSolverType().make(dg_j, s["q0"], s["aux0"],
                                        1.0).vm is None
    ex = ExplicitSolverType().make(dg_t, q0, aux0, 1.0)
    assert ex.vm is None and ex.rhs is dg_t
    with pytest.raises(ValueError, match="vm"):
        JaxExplicitSolverType(state_layout="vm").make(dg_j, s["q0"],
                                                      s["aux0"], 1.0)
    for st in (ExplicitSolverType, IMEXSolverType):
        with pytest.raises(ValueError, match="var-major RHS"):
            st(state_layout="vm").make(dg_t, q0, aux0, 1.0)


@pytest.mark.parametrize("ntr", [1, 2])
def test_tracer_second_order_hooks_match_jax(ntr):
    """NTracers' gradient argument, gradient flux and diffusive flux on
    random inputs, in a schema with a lane before the tracers' (as a
    turbulence closure's chain would build it), against JAX's; and
    NoTracers passes everything through."""
    delta = (1.0, 2.0)[:ntr]
    rng = np.random.default_rng(5)
    E, Np = 3, 4
    nq = 6 + ntr
    prog = dict(rho=1, rhou=3, rhoe=1, pad=1, tracers=dict(rhochi=(ntr,)))
    grad = dict(pad=2, tracers=dict(chi=(ntr,)))
    gf = dict(pad=3, tracers=dict(d_chi=(3, ntr)))

    def specs(cls):
        def make(d):
            return cls(**{k: make(v) if isinstance(v, dict) else v
                          for k, v in d.items()})
        return dict(prog_spec=make(prog), grad_spec=make(grad),
                    gf_spec=make(gf))

    from climatemachine_tpu.atmos.tracers import NTracers as JaxNTracers
    from climatemachine_tpu.utils.variables import VarSpec as JaxVarSpec

    class _J(JaxAtmosModel):
        def __init__(self):
            for k, v in specs(JaxVarSpec).items():
                setattr(self, k, v)

    class _T:
        def __init__(self):
            for k, v in specs(VarSpec).items():
                setattr(self, k, v)

    mj, mt = _J(), _T()
    q = rng.uniform(0.5, 1.5, (E, Np, nq))
    ng, ngf = mj.grad_spec.num, mj.gf_spec.num
    out = rng.standard_normal((E, Np, ng))
    grad_g = rng.standard_normal((E, Np, 3, ng))
    gfv = rng.standard_normal((E, Np, ngf))
    D_t = rng.uniform(0.1, 1.0, (E, Np, 3))
    F = rng.standard_normal((E, Np, 3, nq))
    jt, tt = JaxNTracers(delta), NTracers(delta)
    vm = lambda a: torch.tensor(a).transpose(1, -1).contiguous() \
        if a.ndim == 3 else torch.tensor(a).permute(0, 2, 3, 1).contiguous()
    back = lambda t: (t.numpy().transpose(0, 2, 1) if t.dim() == 3
                      else t.numpy().transpose(0, 3, 1, 2))
    got = tt.gradient_argument(mt, vm(q), None, 0.0, vm(out))
    want = jt.gradient_argument(mj, jnp.asarray(q), None, 0.0,
                                jnp.asarray(out))
    np.testing.assert_allclose(back(got), np.asarray(want), rtol=1e-14)
    got = tt.gradient_flux(mt, vm(grad_g), vm(q), None, 0.0, vm(gfv))
    want = jt.gradient_flux(mj, jnp.asarray(grad_g), jnp.asarray(q), None,
                            0.0, jnp.asarray(gfv))
    np.testing.assert_allclose(back(got), np.asarray(want), rtol=1e-14)
    got = tt.flux_second_order(mt, vm(q), vm(gfv), None,
                               torch.tensor(D_t).transpose(1, 2), vm(F))
    want = jt.flux_second_order(mj, jnp.asarray(q), jnp.asarray(gfv), None,
                                jnp.asarray(D_t), jnp.asarray(F))
    np.testing.assert_allclose(back(got), np.asarray(want), rtol=1e-13)
    none = NoTracers()
    assert none.N == 0 and none.vars_prognostic().num == 0
    assert none.flux_second_order(mt, None, None, None, None, "F") == "F"
