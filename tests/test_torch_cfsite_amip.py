"""The port's cfsite AMIP LES (experiments/cfsite_amip.py) against the
JAX package's example on the CPU in float64, at reduced depth: the
example's 1,800 m × 1,800 m × 4,000 m box at (225, 225, 500) m, 2 × 2 ×
2 elements (the forcings read z_max; the seed mode lives below 400 m),
through ``invoke``: the initial state, dt, the RHS and one step with TMAR
on ρq_tot (tests/single_stack_parity.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

import single_stack_parity as ssp
from climatemachine_tpu import driver_api as jcm
from climatemachine_tpu.atmos.lsforcing import (HadGEMVertical,
                                                LargeScaleProcess,
                                                LargeScaleSubsidence,
                                                LinearSponge)
from climatemachine_tpu_torch.experiments import cfsite_amip
from forced_les_parity import EXACT_INIT_TOL, example

RESOLUTION = (225.0, 225.0, 500.0)


def jax_cfsite():
    """The JAX example's model, as its ``main`` builds it (the init it
    defines there copied)."""
    ex = example("cfsite_amip")
    ps = jcm.EARTH
    xmax, ymax, zmax = cfsite_amip.DOMAIN
    physics = jcm.AtmosPhysics(
        ref_state=jcm.HydrostaticState(
            jcm.DecayingTemperatureProfile(ex.T_SFC, 220.0)),
        turbulence=jcm.Vreman(0.23), moisture=jcm.EquilMoist(),
        lsforcing=HadGEMVertical(ex.hadgem_like_profile))

    def init(m, coords, aux, t):
        z = coords[..., 2]
        prof = ex.hadgem_like_profile(z)
        ta, hus = prof["ta"], prof["hus"]
        pfull = ps.MSLP * (ta / ex.T_SFC) ** (ps.grav / (ps.R_d * ex.GAMMA))
        pp = jcm.td.PhasePartition(hus, jnp.zeros_like(hus),
                                   jnp.zeros_like(hus))
        R_m = jcm.td.gas_constant_air(ps, pp)
        rho = pfull / (R_m * ta)
        ua, va = prof["ua"], prof["va"]
        e_kin = 0.5 * (ua ** 2 + va ** 2)
        rhoe = rho * (jcm.td.internal_energy(ps, ta, pp) + e_kin
                      + ps.grav * z)
        x, y = coords[..., 0], coords[..., 1]
        bump = jnp.where(
            z <= 400.0,
            2e-3 * jnp.sin(np.pi * x / 300.0) * jnp.sin(np.pi * y / 300.0)
            * jnp.sin(np.pi * z / 400.0), 0.0)
        rhoe = rhoe * (1.0 + bump)
        q = m.prog_spec.pack({"rho": rho, "rhoe": rhoe},
                             batch_shape=rho.shape)
        u = jnp.stack([ua, va, jnp.zeros_like(z)], axis=-1)
        q = m.prog_spec.set(q, "rhou", rho[..., None] * u)
        return m.prog_spec.set(q, "moisture.rhoq_tot",
                               rho * hus * (1.0 + bump))

    bc_bottom = jcm.AtmosBC(
        momentum=jcm.Impenetrable(jcm.DragLaw(
            lambda m, q, aux, t, norm_u: (ex.U_STAR / norm_u) ** 2)),
        energy=jcm.PrescribedEnergyFlux(ex.HFLS + ex.HFSS),
        moisture=jcm.PrescribedMoistureFlux(
            lambda m, q, aux, t: ex.HFLS / jcm.td.latent_heat_vapor(
                ps, ex.TS)))
    model = jcm.AtmosModel(
        physics,
        jcm.AtmosProblem(init_state=init,
                         boundary_conditions=(bc_bottom, jcm.AtmosBC())),
        sources=(jcm.Gravity(),
                 LinearSponge(z_max=zmax, z_sponge=zmax * 0.85,
                              alpha_max=1.0, gamma=4.0),
                 LargeScaleProcess(), LargeScaleSubsidence()))
    return jcm.AtmosLESConfiguration("cfsite_amip", 4, RESOLUTION, xmax,
                                     ymax, zmax, model, dtype=np.float64)


@pytest.fixture(scope="module")
def out():
    jdc = jax_cfsite()
    dc = cfsite_amip.cfsite_config(RESOLUTION, device="cpu")
    assert dc.grid.nelem == jdc.grid.nelem == 8
    return ssp.run(jdc, dc, cfsite_amip.COURANT)


def test_initial_state_matches_jax(out):
    ssp.check_init(out, EXACT_INIT_TOL)


def test_rhs_matches_jax(out):
    ssp.check_rhs(out)


def test_step_matches_jax(out):
    ssp.check_step(out)
