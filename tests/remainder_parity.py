"""Shared set-up of the fused-remainder parity tests
(test_torch_remainder_rhs.py, dry; test_torch_remainder_moist.py, moist):
both packages' models on the JAX grid's arrays at n_horz=2, n_vert=2,
p3 in float64, a seeded state, and the JAX ``VarMajorRHS`` of each
remainder case with the "xla" surface pass, all four traced and compiled
as one function."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from climatemachine_tpu.atmos import linear as jax_linear
from climatemachine_tpu.dg.fast_rhs import VarMajorRHS as JaxVarMajorRHS
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init_ode_state
from climatemachine_tpu.dg.spatial import \
    remainder_DGModel as jax_remainder_DGModel
from climatemachine_tpu_torch.atmos import linear
from climatemachine_tpu_torch.dg.fast_rhs import VarMajorRHS
from climatemachine_tpu_torch.dg.spatial import DGModel, remainder_DGModel
from climatemachine_tpu_torch.interop import (grid_from_numpy, grid_to_numpy,
                                              state_from_numpy)

SIZE = dict(n_horz=2, n_vert=2, poly_order=3)
#: the linear models by name: their class's name in both packages
LINEAR = {"gravity": "AtmosAcousticGravityLinearModel",
          "acoustic": "AtmosAcousticLinearModel"}
#: (linear model, its direction) of each case
CASES = [(lin, ldir) for ldir in ("vertical", "every") for lin in LINEAR]
IDS = [f"{ldir}-{lin}" for lin, ldir in CASES]
#: per variable, relative to the reference's largest magnitude: the
#: precedent of tests/test_fast_rhs.py:76
RHS_TOL = 1e-11


def jax_remainders(dg_j, q, aux):
    """{case: the JAX var-major remainder RHS ``[E, nq, Np]`` at (q, aux)}
    for every case of CASES, computed by one jitted function."""
    def rhs_all(q, aux):
        out = {}
        for lin, ldir in CASES:
            model = getattr(jax_linear, LINEAR[lin])(dg_j.balance_law)
            dg_lin = JaxDGModel(model, dg_j.grid, direction=ldir,
                                update_aux=False)
            vm = JaxVarMajorRHS(jax_remainder_DGModel(dg_j, dg_lin))
            assert vm.surface_kernel == "xla"
            out[(lin, ldir)] = vm(vm.to_vm(q), vm.aux_to_vm(aux), 0.0)[0]
        return out

    refs = jax.jit(rhs_all)(jnp.asarray(q), jnp.asarray(aux))
    return {case: np.asarray(r) for case, r in refs.items()}


def port_remainder(dg_t, case):
    """The port's remainder DGModel of ``case`` on ``dg_t``."""
    lin, ldir = case
    model = getattr(linear, LINEAR[lin])(dg_t.balance_law)
    return remainder_DGModel(dg_t, DGModel(model, dg_t.grid, direction=ldir,
                                           update_aux=False))


def build(jax_config, port_config, perturb):
    """Both packages' configurations (the port's on the JAX grid's
    arrays), the test state ``perturb(q0)`` (node-major numpy) and its
    var-major twin, and the JAX references of every case."""
    cfg_j = jax_config(dtype=np.float64, **SIZE)
    dg_j = JaxDGModel(cfg_j.model, cfg_j.grid)
    q0, aux0 = jax_init_ode_state(dg_j)
    q = perturb(np.asarray(q0))
    cfg_t = port_config(dtype=torch.float64, device="cpu", **SIZE)
    grid_t = grid_from_numpy(grid_to_numpy(cfg_j.grid), device="cpu",
                             dtype=torch.float64)
    dg_t = DGModel(cfg_t.model, grid_t)
    qv, auxv = state_from_numpy(q, aux0, device="cpu", model=cfg_t.model)
    return dict(dg_t=dg_t, qv=qv, auxv=auxv,
                refs=jax_remainders(dg_j, q, aux0))


def rel_err_per_var(got, ref):
    """max |got − ref| per variable (axis 1) over max |ref| of it."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return (np.max(np.abs(got - ref), axis=(0, 2))
            / np.maximum(np.max(np.abs(ref), axis=(0, 2)), 1e-300))


def port_rhs(setup, case, mode, **kw):
    """The port's var-major remainder RHS of ``case`` with surface pass
    ``mode`` at the set-up's state."""
    rhs = VarMajorRHS(port_remainder(setup["dg_t"], case), **kw)
    rhs.surface_kernel = mode
    return rhs(setup["qv"], setup["auxv"], 0.0)[0]
