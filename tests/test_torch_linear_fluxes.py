"""The Roe and HLLC fluxes on the linear acoustic(-gravity) models in the
port against the JAX package, in float64 on the CPU, on dry Held-Suarez
(no hyperdiffusion) at n_horz=2, n_vert=2, p3 on the JAX grid's arrays,
from the initial state times 1 + 1e-3·N(0, 1) (numpy, seed 7):

- the vertical linear DGModel (what ``IMEXSolverType`` builds as
  ``dg_lin`` with the full model's flux), for each linear model and flux;
- the fused remainder on the generic surface pass (the full model's Roe
  or HLLC flux less the linear model's on the remainder's faces), for
  each linear model in "vertical" and "every".

On a linear model Roe is the central flux plus the reference state's
acoustic dissipation, and HLLC is Rusanov (JAX
atmos/numerical_fluxes.py:25-66, :174-183).  Per variable, relative to
the JAX result's largest magnitude of that variable, within 1e-11; a
remainder's error is relative to the larger of the two terms it is the
difference of (the JAX full and linear operators): under Roe in "every"
the remainder's ρ tendency is ~1/1400 of them (4.0e-8 against 5.7e-5),
so its round-off is theirs.  The JAX references are computed by one
jitted function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.atmos import linear as jax_linear
from climatemachine_tpu.atmos.numerical_fluxes import (
    HLLCNumericalFlux as JaxHLLC, RoeNumericalFlux as JaxRoe)
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init_ode_state
from climatemachine_tpu.dg.spatial import \
    remainder_DGModel as jax_remainder_DGModel
from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu_torch.atmos import linear
from climatemachine_tpu_torch.dg.numerical_fluxes import (HLLCNumericalFlux,
                                                          RoeNumericalFlux)
from climatemachine_tpu_torch.dg.spatial import DGModel, remainder_DGModel
from climatemachine_tpu_torch.experiments.held_suarez import \
    held_suarez_config
from climatemachine_tpu_torch.interop import (grid_from_numpy, grid_to_numpy,
                                              state_from_numpy)

TOL = 1e-11
SIZE = dict(n_horz=2, n_vert=2, poly_order=3, hyperdiffusion_tau=None)
FLUXES = {"roe": (RoeNumericalFlux, JaxRoe),
          "hllc": (HLLCNumericalFlux, JaxHLLC)}
LINEAR = ("AtmosAcousticGravityLinearModel", "AtmosAcousticLinearModel")
#: (flux, linear model, "linear" for the vertical linear DGModel or the
#: remainder's direction)
CASES = [(nf, lin, kind) for nf in FLUXES for lin in LINEAR
         for kind in ("linear", "vertical", "every")]
IDS = [f"{nf}-{lin[4:-11]}-{kind}" for nf, lin, kind in CASES]


def _operator(pkg, dg_cls, rem_fn, model, grid, nf, lin, kind):
    """The DGModel of a case in either package: the linear model's
    DGModel ("linear": vertical; "linear-every"), the full model's
    ("full") or the remainder in direction ``kind``."""
    if kind == "full":
        return dg_cls(model, grid, numerical_flux_first_order=nf)
    lin_model = getattr(pkg, lin)(model)
    dg_lin = dg_cls(lin_model, grid, direction="every" if kind in (
        "linear-every", "every") else "vertical", update_aux=False,
                    numerical_flux_first_order=nf)
    if kind.startswith("linear"):
        return dg_lin
    return rem_fn(dg_cls(model, grid, numerical_flux_first_order=nf),
                  dg_lin)


def _terms(case):
    """The JAX operators whose difference the remainder ``case`` is."""
    nf, lin, kind = case
    return [(nf, lin, "full"),
            (nf, lin, "linear" if kind == "vertical" else "linear-every")]


@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_held_suarez_config(dtype=np.float64, **SIZE)
    q0, aux0 = jax_init_ode_state(JaxDGModel(cfg_j.model, cfg_j.grid))
    q0 = np.asarray(q0)
    rng = np.random.default_rng(7)
    q = q0 * (1 + 1e-3 * rng.standard_normal(q0.shape))

    keys = set(CASES) | {t for case in CASES if case[2] != "linear"
                         for t in _terms(case)}

    def rhs_all(q, aux):
        return {key: _operator(jax_linear, JaxDGModel,
                               jax_remainder_DGModel, cfg_j.model,
                               cfg_j.grid, FLUXES[key[0]][1](), *key[1:])(
                                   q, aux, 0.0)[0]
                for key in keys}

    refs = jax.jit(rhs_all)(jnp.asarray(q), aux0)
    cfg_t = held_suarez_config(dtype=torch.float64, device="cpu", **SIZE)
    grid_t = grid_from_numpy(grid_to_numpy(cfg_j.grid), device="cpu",
                             dtype=torch.float64)
    qv, auxv = state_from_numpy(q, aux0, device="cpu", model=cfg_t.model)
    return dict(model=cfg_t.model, grid=grid_t, qv=qv, auxv=auxv,
                refs={k: np.asarray(v) for k, v in refs.items()})


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_linear_model_flux_matches_jax(setup, case):
    nf, lin, kind = case
    dg = _operator(linear, DGModel, remainder_DGModel, setup["model"],
                   setup["grid"], FLUXES[nf][0](), lin, kind)
    assert not dg.fast_surface
    got = dg(setup["qv"], setup["auxv"], 0.0)[0].numpy().transpose(0, 2, 1)
    refs = setup["refs"]
    ref = refs[case]
    assert got.shape == ref.shape
    scale = np.max(np.abs(ref), axis=(0, 1))
    if kind != "linear":
        scale = np.max([np.max(np.abs(refs[t]), axis=(0, 1))
                        for t in _terms(case)], axis=0)
    err = np.max(np.abs(got - ref), axis=(0, 1)) / np.maximum(scale, 1e-300)
    assert err.max() < TOL, err
