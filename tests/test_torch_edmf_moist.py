"""The port's moist EDMF single stack (two updrafts over the BOMEX
surface, Obukhov length −100 m, EquilMoist) against the JAX package's
on the CPU in float64: the initial state, the aux refresh and the
gradient flux (tests/edmf_parity.py).  The RHS and the steps are in
test_torch_edmf_moist_steps.py: each JAX function of the moist case
compiles for seconds."""

import pytest

import edmf_parity as ep


@pytest.fixture(scope="module")
def out():
    return ep.run_case("moist", parts=("init", "aux_gf"))


def test_initial_state_matches_jax(out):
    ep.check_init(out)


def test_aux_and_gradient_flux_match_jax(out):
    ep.check_aux_gf(out)
