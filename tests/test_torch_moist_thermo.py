"""The port's moist thermodynamics, the baroclinic wave's analytic state
and its initial state against the JAX package, in float64 on the CPU:

- every thermodynamic function on seeded (T, ρ, q_tot) points (numpy,
  seed 3) that span unsaturated, saturated-liquid and saturated-ice air,
  and the saturation adjustment on the e_int of those points: 1e-12 of
  each output's largest magnitude (the two packages evaluate the same
  formulas in the same order; what is left is the ulp of exp and pow);
- ``bcwave_base_state``, ``bcwave_perturbation`` and
  ``moist_low_tropics_q`` on seeded points, 1e-12;
- ``init_ode_state`` of the moist and the dry configuration at n_horz=2,
  n_vert=2, p3 on the JAX grid's arrays, the lane names, and the state
  carried from the JAX package's arrays to the port and back (exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init_ode_state
from climatemachine_tpu.experiments import baroclinic_wave as jax_bcwave
from climatemachine_tpu.physics import thermodynamics as jax_td
from climatemachine_tpu.physics.parameters import EARTH as JAX_EARTH
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.experiments import baroclinic_wave as bcwave
from climatemachine_tpu_torch.interop import (grid_from_numpy,
                                              grid_to_numpy,
                                              state_from_numpy,
                                              state_to_numpy)
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import EARTH

SIZE = dict(n_horz=2, n_vert=2, poly_order=3)
TOL = 1e-12
N = 600


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)


@pytest.fixture(scope="module")
def points():
    """Seeded T in [190, 320] K, ρ in [0.05, 1.3] kg/m³ and q_tot in
    [0, 0.03], with the equilibrium e_int of each point (from the JAX
    package)."""
    rng = np.random.default_rng(3)
    T = rng.uniform(190.0, 320.0, N)
    rho = rng.uniform(0.05, 1.3, N)
    q_tot = rng.uniform(0.0, 0.03, N)
    pp = jax_td.phase_partition_equil(JAX_EARTH, T, rho, q_tot)
    e_int = np.asarray(jax_td.internal_energy(JAX_EARTH, T, pp))
    return dict(T=T, rho=rho, q_tot=q_tot, e_int=e_int,
                liq=np.asarray(pp.liq), ice=np.asarray(pp.ice))


def test_points_span_the_phases(points):
    unsat = (points["liq"] == 0) & (points["ice"] == 0)
    assert unsat.sum() > 30
    assert (points["liq"] > 0).sum() > 30
    assert (points["ice"] > 0).sum() > 30


def test_parameters_match_jax():
    for name in ("R_v", "molmass_ratio", "cv_v", "cv_l", "cv_i", "LH_f0",
                 "e_int_v0", "e_int_i0", "T_min", "T_max", "T_freeze",
                 "T_triple", "press_triple", "LH_v0", "LH_s0", "cp_v",
                 "cp_l", "cp_i", "molmass_water"):
        assert getattr(EARTH, name) == getattr(JAX_EARTH, name), name


#: name -> (port function, JAX function) of (ps, T, rho, q_tot, pp)
FUNCTIONS = {
    "liquid_fraction": lambda m, T, r, q, pp: m.liquid_fraction(EARTH, T),
    "pvs_liquid": lambda m, T, r, q, pp:
        m.saturation_vapor_pressure_liquid(EARTH, T),
    "pvs_ice": lambda m, T, r, q, pp:
        m.saturation_vapor_pressure_ice(EARTH, T),
    "q_vap_saturation": lambda m, T, r, q, pp:
        m.q_vap_saturation(EARTH, T, r),
    "latent_heat_vapor": lambda m, T, r, q, pp:
        m.latent_heat_vapor(EARTH, T),
    "latent_heat_sublim": lambda m, T, r, q, pp:
        m.latent_heat_sublim(EARTH, T),
    "latent_heat_fusion": lambda m, T, r, q, pp:
        m.latent_heat_fusion(EARTH, T),
    "phase_liq": lambda m, T, r, q, pp:
        m.phase_partition_equil(EARTH, T, r, q).liq,
    "phase_ice": lambda m, T, r, q, pp:
        m.phase_partition_equil(EARTH, T, r, q).ice,
    "gas_constant_air": lambda m, T, r, q, pp: m.gas_constant_air(EARTH, pp),
    "cv_m": lambda m, T, r, q, pp: m.cv_m(EARTH, pp),
    "cp_m": lambda m, T, r, q, pp: m.cp_m(EARTH, pp),
    "internal_energy": lambda m, T, r, q, pp: m.internal_energy(EARTH, T, pp),
    "air_temperature": lambda m, T, r, q, pp:
        m.air_temperature(EARTH, m.internal_energy(EARTH, T, pp), pp),
    "air_pressure": lambda m, T, r, q, pp: m.air_pressure(EARTH, T, r, pp),
    "soundspeed_air": lambda m, T, r, q, pp: m.soundspeed_air(EARTH, T, pp),
    "virtual_temperature": lambda m, T, r, q, pp:
        m.virtual_temperature(EARTH, T, pp),
}


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_thermodynamics_match_jax(points, name):
    fn = FUNCTIONS[name]
    T, rho, q = points["T"], points["rho"], points["q_tot"]
    pp_j = jax_td.phase_partition_equil(JAX_EARTH, T, rho, q)
    t = lambda a: torch.tensor(np.asarray(a))
    pp_t = td.PhasePartition(t(pp_j.tot), t(pp_j.liq), t(pp_j.ice))
    got = fn(td, t(T), t(rho), t(q), pp_t)
    ref = fn(jax_td, jnp.asarray(T), jnp.asarray(rho), jnp.asarray(q), pp_j)
    assert got.dtype == torch.float64
    assert _rel(got, ref) < TOL


def test_saturation_adjustment_matches_jax(points):
    """The adjusted T and the thermo built on it, on the equilibrium e_int
    of the seeded points: it recovers their T, and matches the JAX
    package's, also where the all-vapour short cut applies."""
    t = lambda a: torch.tensor(np.asarray(a))
    e_int, rho, q = points["e_int"], points["rho"], points["q_tot"]
    T_j = jax_td.saturation_adjustment(JAX_EARTH, e_int, rho, q, n_iter=6)
    T_t = td.saturation_adjustment(EARTH, t(e_int), t(rho), t(q), n_iter=6)
    assert _rel(T_t, T_j) < TOL
    assert _rel(T_t, points["T"]) < 1e-9
    pp_j = jax_td.phase_partition_equil(JAX_EARTH, T_j, rho, q)
    pp_t = td.phase_partition_equil(EARTH, T_t, t(rho), t(q))
    for got, ref in ((pp_t.liq, pp_j.liq), (pp_t.ice, pp_j.ice),
                     (td.air_pressure(EARTH, T_t, t(rho), pp_t),
                      jax_td.air_pressure(JAX_EARTH, T_j, rho, pp_j)),
                     (td.soundspeed_air(EARTH, T_t, pp_t),
                      jax_td.soundspeed_air(JAX_EARTH, T_j, pp_j)),
                     (td.virtual_temperature(EARTH, T_t, pp_t),
                      jax_td.virtual_temperature(JAX_EARTH, T_j, pp_j))):
        assert _rel(got, ref) < TOL


def test_bcwave_analytic_state_matches_jax():
    rng = np.random.default_rng(5)
    phi = rng.uniform(-np.pi / 2, np.pi / 2, N)
    lam = rng.uniform(-np.pi, np.pi, N)
    z = rng.uniform(0.0, 30e3, N)
    p = rng.uniform(5e3, 1.05e5, N)
    t = torch.tensor
    for got, ref in zip(bcwave.bcwave_base_state(EARTH, t(phi), t(z)),
                        jax_bcwave.bcwave_base_state(JAX_EARTH, phi, z)):
        assert _rel(got, ref) < TOL
    # points inside the dipole too: around (λ_c, φ_c) = (π/9, 2π/9)
    lam_p = np.concatenate([lam, np.pi / 9 + rng.uniform(-0.1, 0.1, N)])
    phi_p = np.concatenate([phi, 2 * np.pi / 9 + rng.uniform(-0.1, 0.1, N)])
    z_p = np.concatenate([z, rng.uniform(0.0, 15e3, N)])
    got = bcwave.bcwave_perturbation(EARTH, t(phi_p), t(lam_p), t(z_p))
    ref = jax_bcwave.bcwave_perturbation(JAX_EARTH, phi_p, lam_p, z_p)
    assert np.count_nonzero(np.asarray(ref[0])) > 100
    for g, r in zip(got, ref):
        assert _rel(g, r) < TOL
    assert _rel(bcwave.moist_low_tropics_q(EARTH, t(phi), t(p)),
                jax_bcwave.moist_low_tropics_q(JAX_EARTH, phi, p)) < TOL


@pytest.fixture(scope="module", params=[True, False], ids=["moist", "dry"])
def init(request):
    """The configuration of both packages (the port's on the JAX grid's
    arrays) and their initial states."""
    moist = request.param
    cfg_j = jax_bcwave.baroclinic_wave_config(moist=moist, dtype=np.float64,
                                              **SIZE)
    q_j, aux_j = jax_init_ode_state(JaxDGModel(cfg_j.model, cfg_j.grid))
    cfg_t = bcwave.baroclinic_wave_config(moist=moist, dtype=torch.float64,
                                          device="cpu", **SIZE)
    grid_t = grid_from_numpy(grid_to_numpy(cfg_j.grid), device="cpu",
                             dtype=torch.float64)
    q_t, aux_t = init_ode_state(DGModel(cfg_t.model, grid_t))
    return dict(moist=moist, cfg_j=cfg_j, cfg_t=cfg_t, q_j=np.asarray(q_j),
                aux_j=np.asarray(aux_j), q_t=q_t, aux_t=aux_t)


def test_lanes_match_jax(init):
    for spec in ("prog_spec", "aux_spec", "gradlap_spec"):
        assert list(getattr(init["cfg_t"].model, spec).flattened_names()) == \
            list(getattr(init["cfg_j"].model, spec).flattened_names())
    assert init["cfg_t"].model.prog_spec.num == 5 + init["moist"]


def test_init_state_matches_jax(init):
    q_ref, aux_ref = state_from_numpy(init["q_j"], init["aux_j"],
                                      device="cpu",
                                      model=init["cfg_t"].model)
    for got, ref in ((init["q_t"], q_ref), (init["aux_t"], aux_ref)):
        err = (got - ref).abs().amax(dim=(0, 2)) \
            / ref.abs().amax(dim=(0, 2)).clamp_min(1e-300)
        assert err.max() < TOL, err
    if init["moist"]:
        q_tot = init["q_t"][:, 5] / init["q_t"][:, 0]
        assert 0.0 <= q_tot.min() and q_tot.max() < 0.02


def test_state_round_trip_is_exact(init):
    """The JAX package's state and aux, carried to the port and back,
    are the same arrays; a model with other lanes is refused."""
    model = init["cfg_t"].model
    q, aux = state_from_numpy(init["q_j"], init["aux_j"], device="cpu",
                              model=model)
    assert q.shape[1] == model.prog_spec.num and q.is_contiguous()
    q_back, aux_back = state_to_numpy(q, aux, model=model)
    assert np.array_equal(q_back, init["q_j"])
    assert np.array_equal(aux_back, init["aux_j"])
    other = bcwave.baroclinic_wave_config(
        moist=not init["moist"], dtype=torch.float64, device="cpu", **SIZE)
    with pytest.raises(ValueError, match="lanes"):
        state_from_numpy(init["q_j"], init["aux_j"], model=other.model)
    with pytest.raises(ValueError, match="lanes"):
        state_to_numpy(q, aux, model=other.model)
