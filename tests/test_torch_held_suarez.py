"""The port's dry Held-Suarez slice against the JAX package, in float64 on
the CPU at n_horz=2, n_vert=2, p3 (hyperdiffusion off in both):

- the initial state and aux against JAX ``init_ode_state``;
- the var-major RHS on a perturbed state against JAX ``VarMajorRHS``
  (whose Pallas volume kernel runs in interpret mode), 1e-11 relative
  per variable, the tests/test_fast_rhs.py precedent;
- one LSRK54 step with the every-step filter, 1e-12 relative.

The RHS and step tests feed both packages the JAX grid's arrays
(interop.grid_from_numpy) so they hold the RHS apart from the grid
build, which tests/test_torch_grid.py covers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.fast_rhs import VarMajorRHS as JaxVarMajorRHS
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init_ode_state
from climatemachine_tpu.experiments.held_suarez import \
    HeldSuarezStepFilter as JaxHeldSuarezStepFilter
from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu.ode.lsrk import \
    LSRK54CarpenterKennedy as JaxLSRK54CarpenterKennedy
from climatemachine_tpu_torch.dg.fast_rhs import VarMajorRHS
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.experiments.held_suarez import (
    HeldSuarezStepFilter, held_suarez_config)
from climatemachine_tpu_torch.interop import (FLOAT_FIELDS, INDEX_FIELDS,
                                              grid_from_numpy,
                                              state_from_numpy)
from climatemachine_tpu_torch.ode.lsrk import LSRK54CarpenterKennedy

SIZE = dict(n_horz=2, n_vert=2, poly_order=3)


@pytest.fixture(scope="module")
def setup():
    """JAX config, its initial state perturbed from a seeded numpy
    generator, and the port's model on the JAX grid's arrays."""
    cfg_j = jax_held_suarez_config(dtype=np.float64, hyperdiffusion_tau=None,
                                   **SIZE)
    dg_j = JaxDGModel(cfg_j.model, cfg_j.grid)
    q0, aux0 = jax_init_ode_state(dg_j)
    rng = np.random.default_rng(7)
    q = np.asarray(q0) * (1 + 1e-3 * rng.standard_normal(q0.shape))

    cfg_t = held_suarez_config(dtype=torch.float64, hyperdiffusion_tau=None,
                               device="cpu", **SIZE)
    g = cfg_j.grid
    fields = {k: np.asarray(getattr(g, k))
              for k in FLOAT_FIELDS + INDEX_FIELDS}
    fields.update(xi=g.xi, face_perm_identity=g.face_perm_identity)
    grid_t = grid_from_numpy(fields, device="cpu", dtype=torch.float64)
    return dict(cfg_j=cfg_j, dg_j=dg_j, q0=q0, aux0=aux0, q=q,
                cfg_t=cfg_t, dg_t=DGModel(cfg_t.model, grid_t))


def _rel_err_per_var(got_vm, ref_vm):
    """max |got − ref| over elements and nodes, per variable, relative to
    max |ref| of that variable; both var-major [E, n, Np]."""
    got, ref = np.asarray(got_vm), np.asarray(ref_vm)
    scale = np.maximum(np.max(np.abs(ref), axis=(0, 2)), 1e-300)
    return np.max(np.abs(got - ref), axis=(0, 2)) / scale


def test_aux_lanes_match_jax(setup):
    assert list(setup["cfg_t"].model.aux_spec.flattened_names()) == \
        list(setup["cfg_j"].model.aux_spec.flattened_names())
    assert list(setup["cfg_t"].model.prog_spec.flattened_names()) == \
        list(setup["cfg_j"].model.prog_spec.flattened_names())


def test_init_state_matches_jax(setup):
    cfg_t = setup["cfg_t"]
    q, aux = init_ode_state(DGModel(cfg_t.model, cfg_t.grid))
    q_ref, aux_ref = state_from_numpy(setup["q0"], setup["aux0"],
                                      device="cpu")
    assert q.dtype == aux.dtype == torch.float64
    assert _rel_err_per_var(q, q_ref).max() < 1e-12
    assert _rel_err_per_var(aux, aux_ref).max() < 1e-12


def test_rhs_matches_jax(setup):
    vm_j = JaxVarMajorRHS(setup["dg_j"])
    dq_ref, aux_ref = vm_j(vm_j.to_vm(jnp.asarray(setup["q"])),
                           vm_j.aux_to_vm(setup["aux0"]), 0.0)
    qv, auxv = state_from_numpy(setup["q"], setup["aux0"], device="cpu")
    dq, aux = VarMajorRHS(setup["dg_t"])(qv, auxv, 0.0)
    err = _rel_err_per_var(dq, dq_ref)
    assert err.max() < 1e-11, err
    assert _rel_err_per_var(aux, aux_ref).max() < 1e-11


@pytest.mark.parametrize("write_aux", [True, False],
                         ids=["write_aux", "deferred_aux"])
def test_lsrk54_step_with_filter_matches_jax(setup, write_aux):
    cfg_j, dg_j = setup["cfg_j"], setup["dg_j"]
    dt = 0.3 * jax_min_node_distance(cfg_j.grid) / 350.0
    vm_j = JaxVarMajorRHS(dg_j)
    sol_j = JaxLSRK54CarpenterKennedy(vm_j, dt)
    sol_j.post_step = JaxHeldSuarezStepFilter(cfg_j.grid,
                                              cfg_j.model).apply_vm
    q_ref, aux_ref = sol_j.step(vm_j.to_vm(jnp.asarray(setup["q"])),
                                vm_j.aux_to_vm(setup["aux0"]), 0.0)

    dg_t = setup["dg_t"]
    rhs = VarMajorRHS(dg_t, write_aux=write_aux)
    hsf = HeldSuarezStepFilter(dg_t.grid, dg_t.balance_law)
    sol = LSRK54CarpenterKennedy(rhs, dt, post_step=hsf.apply_vm)
    qv, auxv = state_from_numpy(setup["q"], setup["aux0"], device="cpu")
    q1, aux1 = sol.step(qv, auxv, 0.0)
    err = _rel_err_per_var(q1, q_ref)
    assert err.max() < 1e-12, err
    if not write_aux:
        aux1 = rhs.export_aux(q1, aux1)
        # JAX refreshed aux from the last stage's state, before the
        # filter: refresh it from the filtered state as well
        _, _, _, aux_ref = vm_j._thermo_update(q_ref, aux_ref, 0.0)
    assert _rel_err_per_var(aux1, aux_ref).max() < 1e-12
