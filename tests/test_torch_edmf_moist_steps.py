"""The port's moist EDMF single stack against the JAX package's on the
CPU in float64: one RHS at the seeded state and 3 LSRK144 steps with
TMAR (tests/edmf_parity.py)."""

import pytest

import edmf_parity as ep


@pytest.fixture(scope="module")
def out():
    return ep.run_case("moist", parts=("rhs", "steps"))


def test_rhs_matches_jax(out):
    ep.check_rhs(out)


def test_steps_match_jax(out):
    ep.check_steps(out)
