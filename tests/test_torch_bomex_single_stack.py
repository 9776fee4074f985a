"""The port's BOMEX single stack (experiments/bomex_single_stack.py)
against the JAX package's example on the CPU in float64, at reduced
depth (4 elements to 3,000 m: the example's physics and forcings, which
read z_max) through ``invoke``: the initial state, dt, the RHS and one
step with TMAR (tests/single_stack_parity.py)."""

import numpy as np
import pytest

import single_stack_parity as ssp
from climatemachine_tpu import driver_api as jcm
from climatemachine_tpu_torch.experiments import bomex_single_stack
from forced_les_parity import BISECT_INIT_TOL, jax_bomex

NELEM_VERT = 4


@pytest.fixture(scope="module")
def out():
    zmax = bomex_single_stack.ZMAX
    jdc = jcm.SingleStackConfiguration(
        "bomex_single_stack", 4, NELEM_VERT, zmax, jax_bomex("prescribed"),
        hmax=100.0, dtype=np.float64)
    dc = bomex_single_stack.bomex_single_stack_config(NELEM_VERT,
                                                      device="cpu")
    return ssp.run(jdc, dc, bomex_single_stack.COURANT)


def test_initial_state_matches_jax(out):
    # the BOMEX init bisects T from θ_liq (tests/forced_les_parity.py)
    ssp.check_init(out, BISECT_INIT_TOL)


def test_rhs_matches_jax(out):
    ssp.check_rhs(out)


def test_step_matches_jax(out):
    ssp.check_step(out)
