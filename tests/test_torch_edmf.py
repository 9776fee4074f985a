"""The port's EDMF (climatemachine_tpu_torch/atmos/edmf.py) against the
JAX package's on the CPU in float64: the smooth minimum and the
truncated-normal mean, the lane names of every case, and the decoupled
stable-boundary-layer single stack of tests/test_edmf.py (the initial
state, the aux refresh, the gradient flux, the RHS and 3 LSRK144 steps
with TMAR; tests/edmf_parity.py).  The coupled and the moist case are
in test_torch_edmf_coupled.py and test_torch_edmf_moist*.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edmf_parity as ep
from climatemachine_tpu import driver_api as jcm
from climatemachine_tpu.atmos import edmf as jedmf
from climatemachine_tpu_torch.atmos import edmf
from climatemachine_tpu_torch.experiments import bomex_edmf

UNIT_TOL = 1e-14


@pytest.mark.parametrize("n", [2, 3])
def test_lamb_smooth_minimum_matches_jax(n):
    rng = np.random.default_rng(n)
    l = rng.uniform(0.0, 500.0, (64, n))
    l[:8] = l[:8, :1]                       # equal lengths
    l[8:16, 0] = 1e-3                       # one length far below
    for frac, reg in ((0.1, 1.5), (0.3, 1e-3)):
        got = edmf.lamb_smooth_minimum(torch.tensor(l), frac, reg).numpy()
        ref = np.asarray(jedmf.lamb_smooth_minimum(jnp.asarray(l), frac,
                                                   reg))
        assert np.max(np.abs(got - ref) / np.abs(ref)) <= UNIT_TOL


def test_percentile_bounds_mean_norm_matches_jax():
    for low, high in ((0.9, 0.95), (0.9, 1.0 - 1e-9), (0.5, 0.8),
                      (0.95, 0.975), (0.999, 0.9999)):
        got = edmf.percentile_bounds_mean_norm(low, high)
        ref = jedmf.percentile_bounds_mean_norm(low, high)
        assert abs(got - ref) <= UNIT_TOL * abs(ref), (low, high, got, ref)


@pytest.mark.parametrize("case", sorted(ep.JAX_EDMF))
def test_surface_std_matches_jax(case):
    got = np.array(bomex_edmf.CASES[case].edmf().upd_surface_std)
    ref = ep.JAX_EDMF[case]().upd_surface_std
    assert np.max(np.abs(got - ref)) <= 1e-15


@pytest.mark.parametrize("case", sorted(ep.JAX_EDMF))
def test_lanes_match_jax(case):
    """State, aux, gradient and gradient-flux lanes in the JAX package's
    order, the updraft axis kept at N_up = 1."""
    model = bomex_edmf.sbl_model(bomex_edmf.CASES[case].edmf(),
                                 case == "moist")
    jax_model = jcm.AtmosModel(
        jcm.AtmosPhysics(
            ref_state=jcm.HydrostaticState(jcm.DryAdiabaticProfile(265.0,
                                                                   110.0)),
            turbulence=jcm.ConstantKinematicViscosity(0.0),
            moisture=jcm.EquilMoist() if case == "moist" else None,
            turbconv=ep.JAX_EDMF[case]()),
        jcm.AtmosProblem())
    for spec in ("prog_spec", "aux_spec", "grad_spec", "gf_spec"):
        assert getattr(model, spec).flattened_names() == \
            getattr(jax_model, spec).flattened_names(), spec
    names = model.prog_spec.flattened_names()
    assert "turbconv.up_rhoa" in names or "turbconv.up_rhoa[1]" in names


@pytest.fixture(scope="module")
def out():
    return ep.run_case("decoupled")


def test_initial_state_matches_jax(out):
    ep.check_init(out)


def test_aux_and_gradient_flux_match_jax(out):
    ep.check_aux_gf(out)


def test_rhs_matches_jax(out):
    ep.check_rhs(out)


def test_steps_match_jax(out):
    ep.check_steps(out)
