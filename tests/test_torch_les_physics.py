"""The forced LES slice's pointwise physics against the JAX package's,
in float64 on the CPU, on inputs made from a numpy seed:

- the thermodynamic functions the slice added (internal energy of a
  state, total energy, air density, Exner, the dry, liquid-ice and
  virtual potential temperatures, relative humidity, total specific
  enthalpy), dry and moist, within 1e-13 of each output's largest
  magnitude;
- ``temperature_from_theta_liq``: dry within 1e-13; moist, from the
  same 30 bisections, within the last bracket (T_max − T_min)/2³⁰;
- ``surface_conditions`` (10 Monin-Obukhov iterations) over the neutral,
  unstable and stable regimes of tests/test_surface_fluxes.py with each
  universal function, and ``monin_obukhov_length``, within 1e-12;
- TMAR (``mesh/filters.tmar``) on var-major fields with negatives, all
  lanes and one, within 1e-14, and its element integrals kept.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.common import surface_fluxes as jsf
from climatemachine_tpu.mesh.filters import tmar as jax_tmar
from climatemachine_tpu.physics import thermodynamics as jtd
from climatemachine_tpu.physics.parameters import EARTH as JPS
from climatemachine_tpu_torch.common import surface_fluxes as psf
from climatemachine_tpu_torch.mesh.filters import tmar
from climatemachine_tpu_torch.physics import thermodynamics as ptd
from climatemachine_tpu_torch.physics.parameters import EARTH as PPS
from les_parity import grids

TOL = 1e-13
N = 4000


def _states(seed=0):
    """T [K], p [Pa], ρ, q_tot, q_liq, q_ice, e_kin, e_pot, ρu (3, N),
    as numpy: T across freezing, humid to saturated."""
    r = np.random.default_rng(seed)
    T = r.uniform(220.0, 310.0, N)
    p = r.uniform(5e4, 1.05e5, N)
    q_tot = r.uniform(0.0, 0.025, N)
    q_liq = q_tot * r.uniform(0.0, 0.3, N)
    q_ice = q_tot * r.uniform(0.0, 0.2, N)
    return dict(T=T, p=p, rho=p / (287.0 * T), q_tot=q_tot, q_liq=q_liq,
                q_ice=q_ice, e_kin=r.uniform(0.0, 200.0, N),
                e_pot=r.uniform(0.0, 3e4, N),
                rhou=r.normal(0.0, 10.0, (3, N)))


def _both(s, moist):
    """(JAX args, port args) dict pairs; the partition None when dry."""
    j = {k: jnp.asarray(v) for k, v in s.items()}
    t = {k: torch.tensor(v) for k, v in s.items()}
    j["pp"] = (jtd.PhasePartition(j["q_tot"], j["q_liq"], j["q_ice"])
               if moist else None)
    t["pp"] = (ptd.PhasePartition(t["q_tot"], t["q_liq"], t["q_ice"])
               if moist else None)
    return j, t


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.max(np.abs(ref)), 1e-300)
    assert np.max(np.abs(got - ref)) <= tol * scale, (
        np.max(np.abs(got - ref)), scale)


#: name → f(td, ps, args): each function on the shared inputs
FUNCTIONS = {
    "total_energy": lambda td, ps, a: td.total_energy(
        ps, a["e_kin"], a["e_pot"], a["T"], a["pp"]),
    "air_density": lambda td, ps, a: td.air_density(ps, a["T"], a["p"],
                                                    a["pp"]),
    "exner": lambda td, ps, a: td.exner(ps, a["p"], a["pp"]),
    "dry_pottemp": lambda td, ps, a: td.dry_pottemp(ps, a["T"], a["p"],
                                                    a["pp"]),
    "liquid_ice_pottemp": lambda td, ps, a: td.liquid_ice_pottemp(
        ps, a["T"], a["p"], a["pp"]),
    "virtual_pottemp": lambda td, ps, a: td.virtual_pottemp(
        ps, a["T"], a["p"], a["pp"]),
    "relative_humidity": lambda td, ps, a: td.relative_humidity(
        ps, a["T"], a["p"], a["pp"]),
    "total_specific_enthalpy": lambda td, ps, a: td.total_specific_enthalpy(
        ps, a["e_pot"], a["T"], a["pp"]),
}


@pytest.mark.parametrize("moist", [False, True], ids=["dry", "moist"])
@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_thermodynamics_match_jax(name, moist):
    j, t = _both(_states(), moist)
    ref = FUNCTIONS[name](jtd, JPS, j)
    got = FUNCTIONS[name](ptd, PPS, t)
    _close(got.numpy(), ref)


def test_internal_energy_from_state_matches_jax():
    s = _states(1)
    rhoe = s["rho"] * (s["e_pot"] + 2e5)
    ref = jtd.internal_energy_from_state(
        jnp.asarray(s["rho"]), jnp.asarray(rhoe),
        jnp.asarray(s["rhou"].T), jnp.asarray(s["e_pot"]))
    got = ptd.internal_energy_from_state(
        torch.tensor(s["rho"]), torch.tensor(rhoe), torch.tensor(s["rhou"])[
            None], torch.tensor(s["e_pot"]))
    _close(got[0].numpy(), ref)


@pytest.mark.parametrize("moist", [False, True], ids=["dry", "moist"])
def test_temperature_from_theta_liq(moist):
    s = _states(2)
    theta = s["T"] * (1e5 / s["p"]) ** 0.2857 + 2.0
    q = s["q_tot"] if moist else None
    ref = np.asarray(jtd.temperature_from_theta_liq(
        JPS, jnp.asarray(s["p"]), jnp.asarray(theta),
        None if q is None else jnp.asarray(q)))
    tp = torch.tensor(s["p"])
    tq = None if q is None else torch.tensor(q)
    got = ptd.temperature_from_theta_liq(PPS, tp, torch.tensor(theta), tq)
    if not moist:
        _close(got.numpy(), ref)
        return
    bracket = (PPS.T_max - PPS.T_min) / 2 ** 30
    assert np.max(np.abs(got.numpy() - ref)) <= bracket


#: (u, θ_in, θ_sfc) of the neutral, unstable and stable regimes
REGIMES = {"neutral": ([5.0, 10.0], [300.0, 300.0], [300.0, 300.0]),
           "unstable_stable": ([5.0, 5.0], [299.0, 302.0], [302.0, 299.0]),
           "weak_wind": ([0.001, 4.0], [300.5, 300.5], [300.0, 300.0])}
UNIVERSAL = ("Businger", "Gryanik", "Grachev")


@pytest.mark.parametrize("uf", UNIVERSAL)
@pytest.mark.parametrize("regime", list(REGIMES))
def test_surface_conditions_match_jax(regime, uf):
    u, th_in, th_s = (np.asarray(x) for x in REGIMES[regime])
    ref = jsf.surface_conditions(JPS, jnp.asarray(u), jnp.asarray(th_in),
                                 jnp.asarray(th_s), 10.0, 0.1,
                                 uf=getattr(jsf, uf)())
    got = psf.surface_conditions(PPS, torch.tensor(u), torch.tensor(th_in),
                                 torch.tensor(th_s), 10.0, 0.1,
                                 uf=getattr(psf, uf)())
    for g, r in zip(got, ref):
        _close(g.numpy(), r, 1e-12)


@pytest.mark.parametrize("uf", UNIVERSAL)
def test_universal_functions_match_jax(uf):
    zeta = np.linspace(-10.0, 10.0, 401)
    for fn in ("psi_m", "psi_h"):
        ref = getattr(getattr(jsf, uf)(), fn)(jnp.asarray(zeta))
        got = getattr(getattr(psf, uf)(), fn)(torch.tensor(zeta))
        _close(got.numpy(), ref, 1e-12)


def test_monin_obukhov_length_matches_jax():
    r = np.random.default_rng(3)
    u_star, theta = r.uniform(0.05, 0.6, 50), r.uniform(280.0, 310.0, 50)
    flux = r.normal(0.0, 0.1, 50)
    flux[:3] = 0.0
    ref = jsf.monin_obukhov_length(JPS, jnp.asarray(u_star),
                                   jnp.asarray(theta), jnp.asarray(flux))
    got = psf.monin_obukhov_length(PPS, torch.tensor(u_star),
                                   torch.tensor(theta), torch.tensor(flux))
    _close(got.numpy(), ref, 1e-12)


@pytest.fixture(scope="module")
def box():
    return grids(2, 3)


@pytest.mark.parametrize("fields", [None, [1]], ids=["all", "one_lane"])
def test_tmar_matches_jax(box, fields):
    gj, gp = box
    r = np.random.default_rng(4)
    q = r.normal(0.2, 1.0, (gp.nelem, gp.Np, 3))
    q[0] = -np.abs(q[0])               # an element with nothing positive
    ref = np.asarray(jax_tmar(gj, jnp.asarray(q), fields=fields))
    got = tmar(gp, torch.tensor(q.transpose(0, 2, 1).copy()), fields=fields)
    got = got.numpy().transpose(0, 2, 1)
    _close(got, ref, 1e-14)
    assert (got[..., fields or slice(None)] >= 0).all()
    M = gp.M.numpy()[..., None]
    kept = np.sum(M * q, axis=1) > 0
    lanes = fields or [0, 1, 2]
    np.testing.assert_allclose(np.sum(M * got, axis=1)[:, lanes][
        kept[:, lanes]], np.sum(M * q, axis=1)[:, lanes][kept[:, lanes]],
        rtol=1e-13)
