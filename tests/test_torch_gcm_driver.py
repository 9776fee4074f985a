"""The GCM driver entry in the port against the JAX package, in float64
on the CPU:

- ``AtmosGCMConfiguration``'s grid (n_horz 2, n_vert 2, p3): coordinates
  and metric terms against the JAX package's within 1e-12 relative, with
  the planet's radius, another radius and a mesh warp given by name and
  as a callable;
- ``gcm_driver_config``'s initial state (n_horz 2, n_vert 2, p3) for
  each base state (heldsuarez, bc_wave, zero), the Zero and
  Deterministic perturbations, each moisture profile, dry and moist,
  and each surface flux, against the JAX initial condition on the same
  aux within 1e-12 relative per variable; the bulk flux's
  ``VaryingSSTTJ16`` surface temperature and humidity the same;
- (one LSRK54 step of the moist heldsuarez and of its bulk variant:
  tests/test_torch_gcm_driver_step.py, apart for the 30 s a file);
- ``RandomPerturbation`` by its law (the JAX one draws from
  ``jax.random``, which the port does not reproduce): the factor within
  1 ± amplitude, spread over that range, the same field for the same
  seed and another for another seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.spatial import \
    init_state_auxiliary as jax_init_aux
from climatemachine_tpu.driver.configs import \
    AtmosGCMConfiguration as JaxAtmosGCMConfiguration
from climatemachine_tpu.experiments import gcm_driver as jgcm
from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu.mesh.topology import \
    equiangular_cubed_sphere_warp as jax_warp
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.driver.configs import AtmosGCMConfiguration
from climatemachine_tpu_torch.experiments import gcm_driver as pgcm
from climatemachine_tpu_torch.experiments.held_suarez import \
    held_suarez_config
from climatemachine_tpu_torch.interop import grid_to_numpy, to_node_major

SIZE = dict(n_horz=2, n_vert=2, poly_order=3)
TOL = 1e-12
GRID_FIELDS = ("coords", "M", "JcV")

#: id -> gcm_driver_config keywords: every base state, the Zero and
#: Deterministic perturbations, each moisture profile, each surface flux
CASES = {
    "hs_default": dict(),
    "bcwave_bulk": dict(experiment="baroclinic_wave", surface_flux="bulk"),
    "zero_dry": dict(init_base_state="zero", init_perturbation="zero",
                     init_moisture_profile="zero", moist=False),
    "hs_zero_moisture": dict(init_perturbation="zero",
                             init_moisture_profile="zero"),
    "hs_bulk": dict(surface_flux="bulk"),
}


def rel_err_per_var(got, ref):
    """Node-major arrays: max |got − ref| over max |ref| per lane."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.maximum(np.abs(ref).max(axis=(0, 1)), 1e-300)
    return np.abs(got - ref).max(axis=(0, 1)) / scale


def configs(case):
    kw = dict(CASES[case], dtype=np.float64, **SIZE)
    cj = jgcm.gcm_driver_config(**kw)
    kw["dtype"] = torch.float64
    return cj, pgcm.gcm_driver_config(device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_aux():
    """The JAX initial aux of each model kind (moist, dry)."""
    out = {}
    for case in ("hs_default", "zero_dry"):
        cj, _ = configs(case)
        out[case] = jax_init_aux(cj.model, cj.grid)
    return out


@pytest.mark.parametrize("kw", [dict(), dict(planet_radius=6.0e6),
                                dict(meshwarp="equiangular"),
                                dict(meshwarp="callable")],
                         ids=["default", "radius", "warp_name",
                              "warp_callable"])
def test_gcm_configuration_grid(kw):
    model_t = held_suarez_config(dtype=torch.float64, device="cpu",
                                 **SIZE).model
    model_j = jax_held_suarez_config(dtype=np.float64, **SIZE).model
    from climatemachine_tpu_torch.mesh.topology import \
        equiangular_cubed_sphere_warp
    kj, kt = dict(kw), dict(kw)
    if kw.get("meshwarp") == "callable":
        kj["meshwarp"], kt["meshwarp"] = jax_warp, \
            equiangular_cubed_sphere_warp
    dj = JaxAtmosGCMConfiguration("gcm", 3, (2, 2), 30e3, model_j,
                                  dtype=np.float64, **kj)
    dt = AtmosGCMConfiguration("gcm", 3, (2, 2), 30e3, model_t,
                               dtype=np.float64, device="cpu", **kt)
    assert dt.grid.nelem == dj.grid.nelem == 48
    assert dt.config_info == dj.config_info
    got = grid_to_numpy(dt.grid)
    for name in GRID_FIELDS:
        ref = np.asarray(getattr(dj.grid, name))
        assert np.abs(got[name] - ref).max() <= TOL * np.abs(ref).max(), \
            name
    r = np.linalg.norm(got["coords"], axis=-1)         # [E, Np, 3]
    a = kw.get("planet_radius", 6.371e6)
    assert abs(r.min() - a) < 1e-6 and abs(r.max() - a - 30e3) < 1e-6


@pytest.mark.parametrize("case", list(CASES))
def test_initial_state(case, jax_aux):
    cj, ct = configs(case)
    aux_j = jax_aux["zero_dry" if not ct.model.moist else "hs_default"]
    q_ref = cj.model.problem.init_state(cj.model, cj.grid.coords, aux_j, 0.0)
    q, aux = init_ode_state(DGModel(ct.model, ct.grid))
    # the lanes the initial aux fills (the port's init_ode_state also
    # refreshes the moisture model's, which the JAX aux holds at 0)
    filled = np.abs(np.asarray(aux_j)).max(axis=(0, 1)) > 0
    assert filled.sum() >= 8
    assert max(rel_err_per_var(to_node_major(aux)[..., filled],
                               np.asarray(aux_j)[..., filled])) < TOL
    assert max(rel_err_per_var(to_node_major(q), q_ref)) < TOL
    bcs_j = cj.model.problem.boundary_conditions
    bcs_t = ct.model.problem.boundary_conditions
    assert [type(b.energy).__name__ for b in bcs_t] == \
        [type(b.energy).__name__ for b in bcs_j]
    assert [type(b.moisture).__name__ for b in bcs_t] == \
        [type(b.moisture).__name__ for b in bcs_j]
    if CASES[case].get("surface_flux") == "bulk":
        sst_j, sst_t = jgcm.VaryingSSTTJ16(), pgcm.VaryingSSTTJ16()
        # on the port's refreshed aux (the JAX initial aux holds no
        # temperature, which q_sfc's thermo reads)
        qj, aj = (jnp.asarray(to_node_major(x)) for x in (q, aux))
        for fn in ("T_sfc", "q_sfc"):
            ref = getattr(sst_j, fn)(cj.model, qj, aj, 0.0)
            got = getattr(sst_t, fn)(ct.model, q, aux, 0.0)
            assert np.abs(got.numpy() - np.asarray(ref)).max() \
                <= TOL * np.abs(np.asarray(ref)).max(), fn
        assert bcs_t[0].energy.C_h == bcs_j[0].energy.C_h == 0.0044


def test_bad_names():
    with pytest.raises(ValueError, match="unknown experiment"):
        pgcm.gcm_driver_config("dycoms", device="cpu", **SIZE)
    with pytest.raises(ValueError, match="moisture model"):
        pgcm.parse_surface_flux("bulk", moist=False)


def test_random_perturbation_law():
    _, ct = configs("zero_dry")
    z = torch.linspace(0.0, 30e3, 4000, dtype=torch.float64).reshape(40, 100)
    amp = 1e-3
    f1 = pgcm.RandomPerturbation(seed=3, amplitude=amp)(ct.model, z, z, z)[2]
    f2 = pgcm.RandomPerturbation(seed=3, amplitude=amp)(ct.model, z, z, z)[2]
    f3 = pgcm.RandomPerturbation(seed=4, amplitude=amp)(ct.model, z, z, z)[2]
    assert f1.shape == z.shape and f1.dtype == z.dtype
    assert torch.equal(f1, f2) and not torch.equal(f1, f3)
    u = (f1 - 1.0) / amp
    assert float(u.min()) >= -1.0 and float(u.max()) < 1.0
    # U(−1, 1): mean 0 and variance 1/3, 4000 draws (5 standard errors)
    assert abs(float(u.mean())) < 5 * (1 / 3) ** 0.5 / 4000 ** 0.5
    assert abs(float(u.var()) - 1 / 3) < 0.03
    assert float(u.min()) < -0.99 and float(u.max()) > 0.99
    # through the initial condition: ρe scaled by the factor, ρ not
    q0, _ = init_ode_state(DGModel(ct.model, ct.grid))
    ct_r = pgcm.gcm_driver_config(
        init_base_state="zero", init_perturbation="random",
        init_moisture_profile="zero", moist=False, dtype=torch.float64,
        device="cpu", **SIZE)
    q_r, _ = init_ode_state(DGModel(ct_r.model, ct_r.grid))
    assert torch.equal(q_r[:, 0], q0[:, 0])
    ratio = q_r[:, 4] / q0[:, 4]
    assert float((ratio - 1).abs().max()) <= amp * (1 + 1e-12)
    assert float((ratio - 1).abs().max()) > 0.5 * amp
