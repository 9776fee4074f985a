"""The port's coupled EDMF single stack (the SGS fluxes fed back on the
grid mean; the stored-profile gate's case) against the JAX package's on
the CPU in float64: the initial state, the aux refresh, the gradient
flux, the RHS and 3 LSRK144 steps with TMAR (tests/edmf_parity.py)."""

import numpy as np
import pytest

import edmf_parity as ep


@pytest.fixture(scope="module")
def out():
    return ep.run_case("coupled")


def test_initial_state_matches_jax(out):
    ep.check_init(out)


def test_aux_and_gradient_flux_match_jax(out):
    ep.check_aux_gf(out)


def test_rhs_matches_jax(out):
    ep.check_rhs(out)


def test_steps_match_jax(out):
    ep.check_steps(out)


def test_coupling_moves_the_grid_mean(out):
    """The coupled RHS differs from the decoupled one on ρe (the SGS
    enthalpy flux), as tests/test_edmf.py's coupled test checks."""
    from climatemachine_tpu_torch.experiments import bomex_edmf
    from les_parity import vm
    rhs = {}
    for case in ("coupled", "decoupled"):
        model, dg, *_ = bomex_edmf.sbl_stack(case, ep.NZ, device="cpu")
        rhs[case] = dg(vm(ep.seeded(out["jax_q0"], out["names"])),
                       vm(out["jax_aux0"]), 0.0)[0]
    e = out["names"].index("rhoe")
    assert float((rhs["coupled"][:, e] - rhs["decoupled"][:, e]).abs()
                 .max()) > 1e-12
    assert np.isfinite(rhs["coupled"].numpy()).all()
