"""DYCOMS radiation and NonEquilMoist in the port against the JAX
package, in float64 on the CPU, on tests/test_radiation.py's set-up
(:30-74: an element-wise constant cloud slab of ρq_liq between 600 and
900 m in a 1000 × 1000 × 1500 m box at p4, NonEquilMoist, no closure):

- the initial state and the aux of ``init_ode_state`` (T and θ_v of
  NonEquilMoist, the attenuation paths ``radiation.int_att`` and
  ``radiation.int_att_rev``) within 1e-12 per lane;
- the JAX test's own checks (:77-115) on the port: the paths against
  the slab's analytic integrals within 1e-10, the three-term flux within
  1e-9, the RHS finite and cooling below the cloud top;
- the RHS at the JAX initial state times 1 + 1e-3 · N(0, 1) within 1e-10
  per variable, and the paths of ``ColumnOps`` on a random integrand
  against the JAX package's within 1e-12;
- the paths' integrand with q_liq from the aux lane (EquilMoist) and
  from the state (NonEquilMoist).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.spatial import init_ode_state as jax_init
from climatemachine_tpu_torch import driver_api as cm
from climatemachine_tpu_torch.atmos.moisture import NonEquilMoist
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from forced_les_parity import lane_err, var_err
from les_parity import nm, perturbed, vm
from test_radiation import C, ZB, ZT, _setup

TOL = 1e-10
ps = cm.EARTH


def _port(jgrid):
    """The port's model and grid of tests/test_radiation.py's set-up."""
    rad = cm.DYCOMSRadiationModel(kappa=85.0, alpha_z=1.0, z_i=840.0,
                                  rho_i=1.13, D_subsidence=3.75e-6, F_0=70.0,
                                  F_1=22.0)
    physics = cm.AtmosPhysics(
        orientation=cm.FlatOrientation(),
        ref_state=cm.HydrostaticState(cm.DecayingTemperatureProfile(290.0,
                                                                    220.0)),
        moisture=NonEquilMoist(), radiation=rad)

    def init(m, coords, aux, t):
        s = m.aux_spec
        rho = s.get(aux, "ref_state.rho")
        p = s.get(aux, "ref_state.p")
        Phi = s.get(aux, "orientation.Phi")
        z = coords[:, 2]
        T = p / (ps.R_d * rho)
        zc = torch.mean(z, dim=-1, keepdim=True)
        rhoql = torch.where((zc > ZB) & (zc < ZT), torch.full_like(zc, C),
                            0.0) * torch.ones_like(z)
        rhoqt = rhoql + 0.004 * rho
        pp = cm.td.PhasePartition(rhoqt / rho, rhoql / rho,
                                  torch.zeros_like(rho))
        rhoe = rho * cm.td.internal_energy(ps, T, pp) + rho * Phi
        return m.prog_spec.pack({"rho": rho, "rhoe": rhoe,
                                 "moisture.rhoq_tot": rhoqt,
                                 "moisture.rhoq_liq": rhoql})

    model = cm.AtmosModel(physics, cm.AtmosProblem(
        init_state=init, boundary_conditions=(cm.AtmosBC(), cm.AtmosBC())),
        sources=(cm.Gravity(),))
    r = [np.linspace(0, 1e3, 3), np.linspace(0, 1e3, 3),
         np.linspace(0, 1500.0, 6)]
    topo = cm.topology.stacked_brick_topology(
        r, periodicity=(True, True, False),
        boundary=np.array([[0, 0], [0, 0], [1, 2]]))
    grid = cm.make_grid(topo, 4, dtype=torch.float64, device="cpu")
    return model, grid, rad


@pytest.fixture(scope="module")
def setup():
    jmodel, jgrid, jdg, jrad = _setup()
    q0, aux0 = jax_init(jdg)
    model, grid, rad = _port(jgrid)
    dg = DGModel(model, grid)
    q, aux = init_ode_state(dg)
    return dict(jmodel=jmodel, jgrid=jgrid, jdg=jdg, jq=np.asarray(q0),
                jaux=np.asarray(aux0), model=model, grid=grid, dg=dg, rad=rad,
                q=q, aux=aux)


def test_schema_matches_jax(setup):
    jm, m = setup["jmodel"], setup["model"]
    for spec in ("prog_spec", "aux_spec"):
        assert list(getattr(m, spec).flattened_names()) == list(
            getattr(jm, spec).flattened_names())
    assert m.grad_spec.num == 0 and not setup["dg"].dry_volume
    assert not setup["dg"].fast_surface


def test_init_matches_jax(setup):
    assert np.all(lane_err(nm(setup["q"]), setup["jq"]) <= 1e-12)
    err = lane_err(nm(setup["aux"]), setup["jaux"])
    assert np.all(err <= 1e-12), err


def test_paths_and_flux_analytic(setup):
    """tests/test_radiation.py:77-115 on the port."""
    model, grid, dg, rad = (setup[k] for k in ("model", "grid", "dg", "rad"))
    q, aux = setup["q"], model.update_auxiliary_state(setup["q"],
                                                      setup["aux"], grid)
    z = grid.coords[..., 2].numpy()
    want_up = rad.kappa * C * np.clip(np.minimum(z, ZT) - ZB, 0.0, None)
    want_dn = rad.kappa * C * np.clip(ZT - np.maximum(z, ZB), 0.0, None)
    got_up = model.aux_spec.get(aux, "radiation.int_att").numpy()
    got_dn = model.aux_spec.get(aux, "radiation.int_att_rev").numpy()
    assert np.max(np.abs(got_up - want_up)) < 1e-10
    assert np.max(np.abs(got_dn - want_dn)) < 1e-10
    dz_i = np.maximum(z - rad.z_i, 0.0)
    want_F = (rad.F_1 * np.exp(-want_up) + rad.F_0 * np.exp(-want_dn)
              + rad.rho_i * ps.cp_d * rad.D_subsidence * rad.alpha_z
              * np.cbrt(dz_i) * (dz_i / 4 + rad.z_i))
    Fz = rad.energy_flux(model, q, aux)[:, 2].numpy()
    assert np.max(np.abs(Fz - want_F)) < 1e-9
    tend, _ = dg(q, aux, 0.0)
    assert bool(torch.isfinite(tend).all())
    rhoe_t = model.prog_spec.get(tend, "rhoe").numpy()
    assert rhoe_t[(z > 820.0) & (z < 900.0)].mean() < 0.0


def test_rhs_matches_jax(setup):
    qp = perturbed(setup["jq"], seed=0)
    jdg = setup["jdg"]
    ref = np.asarray(jax.jit(lambda a, b: jdg(a, b, 0.0)[0])(
        jnp.asarray(qp), jnp.asarray(setup["jaux"])))
    got = nm(setup["dg"](vm(qp), vm(setup["jaux"]), 0.0)[0])
    err = var_err(got, ref)
    assert np.all(err <= TOL), err


@pytest.mark.parametrize("direction", ["up", "down"])
def test_column_integrals_match_jax(setup, direction):
    r = np.random.default_rng(1)
    g, jg = setup["grid"], setup["jgrid"]
    f = r.uniform(0.0, 1e-3, (g.nelem, g.Np, 1))
    from climatemachine_tpu.dg.columns import ColumnOps as JaxColumnOps
    jops, ops = JaxColumnOps(jg), setup["model"].column_ops(g)
    assert setup["model"].column_ops(g) is ops
    name = ("indefinite_integral" if direction == "up"
            else "reverse_indefinite_integral")
    ref = np.asarray(getattr(jops, name)(jnp.asarray(f)))
    got = nm(getattr(ops, name)(vm(f)))
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))


def test_integrand_sources(setup):
    """κ ρ q_liq from the prognostic ρq_liq (NonEquilMoist) or, for a
    model without it, from the aux lane ``moisture.q_liq``."""
    model, rad, q, aux = (setup[k] for k in ("model", "rad", "q", "aux"))
    sp = model.prog_spec
    want = rad.kappa * sp.get(q, "moisture.rhoq_liq")
    torch.testing.assert_close(rad.integrand(model, q, aux), want,
                               rtol=1e-15, atol=0.0)
    eq = cm.AtmosModel(cm.AtmosPhysics(moisture=cm.EquilMoist(),
                                       radiation=rad), model.problem)
    q_eq = eq.prog_spec.pack({"rho": sp.get(q, "rho")})
    aux_eq = torch.zeros((q.shape[0], eq.aux_spec.num, q.shape[2]),
                         dtype=q.dtype)
    aux_eq[:, eq.aux_spec.index("moisture.q_liq")] = 2e-4
    torch.testing.assert_close(
        rad.integrand(eq, q_eq, aux_eq),
        sp.get(q, "rho") * rad.kappa * 2e-4, rtol=1e-15, atol=0.0)


def test_interop_carries_lanes(setup):
    """The JAX state and aux, NonEquilMoist's and radiation's lanes
    among them, carried over by ``interop`` with their names checked."""
    from climatemachine_tpu_torch.interop import (state_from_numpy,
                                                  state_to_numpy)
    jm, m = setup["jmodel"], setup["model"]
    names = (jm.prog_spec.flattened_names(), jm.aux_spec.flattened_names())
    q, aux = state_from_numpy(setup["jq"], setup["jaux"], device="cpu",
                              model=m, names=names)
    assert "radiation.int_att_rev" in names[1]
    assert "moisture.rhoq_liq" in names[0]
    back = state_to_numpy(q, aux, model=m)
    np.testing.assert_array_equal(back[0], setup["jq"])
    np.testing.assert_array_equal(back[1], setup["jaux"])


@pytest.mark.parametrize("moisture", ["dry", "nonequil"])
def test_radiation_takes_the_generic_passes(setup, moisture):
    """A model with radiation (dry or NonEquilMoist) runs neither the dry
    volume kernel, nor the var-major surface pass, nor the var-major RHS,
    whose first-order flux leaves radiation's out (as the JAX package's
    ``supports`` refuse it)."""
    from climatemachine_tpu_torch.dg import fast_rhs
    model = setup["model"]
    physics = model.physics
    if moisture == "dry":
        from dataclasses import replace
        physics = replace(physics, moisture=cm.DryModel())
    m = cm.AtmosModel(physics, model.problem, model.sources)
    dg = DGModel(m, setup["grid"])
    assert not dg.dry_volume and not dg.fast_surface
    assert not fast_rhs.supports(dg)
