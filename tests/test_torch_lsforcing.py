"""The large-scale forcing and the LES sources in the port against the
JAX package, in float64 on the CPU:

- tests/test_atmos_extras.py:388's set-up (HadGEMVertical with a
  closed-form profile, EquilMoist, ConstantKinematicViscosity(0), the
  three cfsite sources, 3 × 3 × 4 elements at p3): the aux of
  ``init_ode_state`` within 1e-12 per lane, the RHS at the state times
  1 + 1e-3 · N(0, 1) within 1e-10 per variable, and the JAX test's own
  checks on the port (tests/test_torch_bulk_moisture.py holds
  :463's);
- each LES source (GeostrophicForcing, Subsidence, RayleighSponge, the
  three large-scale sources, BOMEX's geostrophic and tendency sources)
  on the HadGEM model at a perturbed state with the JAX gradient flux of
  a gradient made from a numpy seed, within 1e-12 of the largest
  magnitude of each JAX contribution; without a gradient flux the
  gradient-reading sources add nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu import driver_api as jcm
from climatemachine_tpu.atmos import lsforcing as jls
from climatemachine_tpu_torch import driver_api as cm
from climatemachine_tpu_torch.atmos import lsforcing as pls
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.experiments import bomex_les
from forced_les_parity import example, lane_err, var_err
from les_parity import nm, perturbed, vm
from test_atmos_extras import _grid

TOL = 1e-10
DTDT, WSUB, DTDZ = 2e-4, -0.02, -0.005


def _port_grid(L=1000.0, n=3, nz=4, poly=3):
    r = [np.linspace(0, L, n + 1)] * 2 + [np.linspace(0, L, nz + 1)]
    topo = cm.topology.stacked_brick_topology(
        r, periodicity=(True, True, False),
        boundary=np.array([[0, 0], [0, 0], [1, 2]]))
    return cm.make_grid(topo, poly, dtype=torch.float64, device="cpu")


def _hadgem(pkg, xp, ls):
    """tests/test_atmos_extras.py:388's model in package ``pkg`` (array
    module ``xp``, lsforcing module ``ls``)."""
    ps = pkg.EARTH
    var_major = xp is torch

    def profile(z):
        zero = xp.zeros_like(z)
        return dict(ta=300.0 + DTDZ * z, hus=zero + 0.008, ua=zero + 3.0,
                    va=zero - 1.0, temp_tendency=zero + DTDT,
                    qt_tendency=zero + 1e-7, w_s=zero + WSUB)

    def init(m, coords, aux, t):
        p = m.aux_spec.get(aux, "ref_state.p")
        Phi = m.aux_spec.get(aux, "orientation.Phi")
        T = 300.0 * (p / ps.MSLP) ** ps.kappa_d
        rho = p / (ps.R_d * T)
        vals = {"rho": rho,
                "rhoe": rho * (pkg.td.internal_energy(ps, T) + Phi),
                "moisture.rhoq_tot": rho * 0.0}
        return (m.prog_spec.pack(vals) if var_major
                else m.prog_spec.pack(vals, batch_shape=rho.shape))

    physics = pkg.AtmosPhysics(
        ref_state=pkg.HydrostaticState(pkg.DryAdiabaticProfile(300.0,
                                                               110.0)),
        turbulence=pkg.ConstantKinematicViscosity(0.0),
        moisture=pkg.EquilMoist(), lsforcing=ls.HadGEMVertical(profile))
    return pkg.AtmosModel(
        physics,
        pkg.AtmosProblem(init_state=init,
                         boundary_conditions=(pkg.AtmosBC(), pkg.AtmosBC())),
        sources=(pkg.Gravity(), ls.LargeScaleProcess(),
                 ls.LargeScaleSubsidence(),
                 ls.LinearSponge(z_max=1000.0, z_sponge=600.0,
                                 alpha_max=1.0)))


def _bulk_moisture(pkg, xp):
    """tests/test_atmos_extras.py:463's model in package ``pkg``."""
    ps = pkg.EARTH
    var_major = xp is torch

    def init(m, coords, aux, t):
        p = m.aux_spec.get(aux, "ref_state.p")
        Phi = m.aux_spec.get(aux, "orientation.Phi")
        T = 300.0 * (p / ps.MSLP) ** ps.kappa_d
        rho = p / (ps.R_d * T)
        u = xp.full_like(rho, 5.0)
        vals = {"rho": rho, "rhoe": rho * (pkg.td.internal_energy(ps, T)
                                           + Phi + 0.5 * 25.0),
                "moisture.rhoq_tot": rho * 1e-3}
        if var_major:
            vals["rhou"] = torch.stack([rho * u, 0 * u, 0 * u], dim=1)
            return m.prog_spec.pack(vals)
        q = m.prog_spec.pack(vals, batch_shape=rho.shape)
        return m.prog_spec.set(q, "rhou", jnp.stack([rho * u, 0 * u, 0 * u],
                                                    axis=-1))

    bcs = (pkg.AtmosBC(momentum=pkg.Impenetrable(pkg.FreeSlip()),
                       moisture=pkg.BulkFormulaMoisture(C_q=1e-2,
                                                        q_tot_sfc=0.01)),
           pkg.AtmosBC())
    physics = pkg.AtmosPhysics(
        ref_state=pkg.HydrostaticState(pkg.DryAdiabaticProfile(300.0,
                                                               110.0)),
        turbulence=pkg.ConstantKinematicViscosity(0.0),
        moisture=pkg.EquilMoist())
    return pkg.AtmosModel(physics, pkg.AtmosProblem(
        init_state=init, boundary_conditions=bcs), sources=())


def _pair(build_jax, build_port, nz):
    jm, pm = build_jax(), build_port()
    jg, pg = _grid(nz=nz, poly=3), _port_grid(nz=nz)
    jdg, dg = jcm.DGModel(jm, jg), DGModel(pm, pg)
    q0, aux0 = jcm.init_ode_state(jdg)
    q, aux = init_ode_state(dg)
    rhs = jax.jit(lambda a, b, t: jdg(a, b, t))
    return dict(jm=jm, pm=pm, jg=jg, pg=pg, dg=dg, rhs=rhs,
                jq=np.asarray(q0), jaux=np.asarray(aux0), q=q, aux=aux)


@pytest.fixture(scope="module")
def hadgem():
    return _pair(lambda: _hadgem(jcm, jnp, jls),
                 lambda: _hadgem(cm, torch, pls), nz=4)


def _rhs_err(d, seed=0):
    qp = perturbed(d["jq"], seed=seed)
    ref = np.asarray(d["rhs"](jnp.asarray(qp), jnp.asarray(d["jaux"]),
                              0.0)[0])
    return var_err(nm(d["dg"](vm(qp), vm(d["jaux"]), 0.0)[0]), ref)


def test_hadgem_aux_matches_jax(hadgem):
    d = hadgem
    assert list(d["pm"].aux_spec.flattened_names()) == list(
        d["jm"].aux_spec.flattened_names())
    assert np.all(var_err(nm(d["q"]), d["jq"]) <= 1e-12)
    err = lane_err(nm(d["aux"]), d["jaux"])
    assert np.all(err <= 1e-12), err
    z = d["pm"].aux_spec.get(d["aux"], "orientation.Phi") / cm.EARTH.grav
    torch.testing.assert_close(
        d["pm"].aux_spec.get(d["aux"], "lsforcing.ta"), 300.0 + DTDZ * z,
        rtol=1e-12, atol=0.0)


def test_hadgem_rhs_matches_jax(hadgem):
    err = _rhs_err(hadgem)
    assert np.all(err <= TOL), err


def test_hadgem_checks(hadgem):
    """tests/test_atmos_extras.py:435-460 on the port: the energy
    tendency ≈ ρ(c_vd(Σ_T + w_s ∂T/∂z) + e_int,v0 q̇) in the interior, the
    sponge pushing a fluid at rest toward (ua, va) aloft only."""
    d = hadgem
    pm, dg, q0, aux = d["pm"], d["dg"], d["q"], d["aux"]
    ps = cm.EARTH
    tend, _ = dg(q0, aux, 0.0)
    z = (pm.aux_spec.get(aux, "orientation.Phi") / ps.grav).numpy()
    rho = pm.prog_spec.get(q0, "rho").numpy()
    te = pm.prog_spec.get(tend, "rhoe").numpy()
    expect = rho * (ps.cv_d * (DTDT + WSUB * DTDZ) + ps.e_int_v0 * 1e-7)
    assert 0.8 < np.median(te[z > 100.0] / expect[z > 100.0]) < 1.2
    q1 = q0.clone()
    q1[:, pm.prog_spec.index("rhou")] = 0.0
    tm = pm.prog_spec.get(dg(q1, aux, 0.0)[0], "rhou").numpy()
    hi, lo = z > 900.0, z < 200.0
    assert (tm[:, 0][hi] > 1e-3).all() and (tm[:, 1][hi] < -1e-4).all()
    assert np.abs(tm[:, :2][np.broadcast_to(lo[:, None], tm[:, :2].shape)]
                  ).max() < 1e-3 * np.abs(tm[:, :2]).max() + 1e-12


def _sources(pkg, ls, bomex):
    return {
        "geostrophic": pkg.GeostrophicForcing(1e-4, 5.0, -2.0),
        "subsidence": pkg.Subsidence(3.75e-6),
        "rayleigh_sponge": pkg.RayleighSponge(
            z_max=1000.0, z_sponge=500.0, alpha_max=0.5,
            u_relaxation=(5.0, -2.0, 0.0)),
        "large_scale_process": ls.LargeScaleProcess(),
        "large_scale_subsidence": ls.LargeScaleSubsidence(),
        "linear_sponge": ls.LinearSponge(z_max=1000.0, z_sponge=400.0,
                                         alpha_max=0.5, gamma=3.0),
        "bomex_geostrophic": bomex.BomexGeostrophic(1000.0),
        "bomex_tendencies": bomex.BomexTendencies(1000.0),
    }


@pytest.fixture(scope="module")
def forcing_state(hadgem):
    d = hadgem
    jm, jg = d["jm"], d["jg"]
    q = jnp.asarray(perturbed(d["jq"], seed=2))
    q = jm.prog_spec.set(q, "rhou", jnp.asarray(np.random.default_rng(
        3).normal(0.0, 5.0, q.shape[:2] + (3,))) * jm.prog(q, "rho")[
            ..., None])
    q = jm.prog_spec.set(q, "moisture.rhoq_tot", 0.01 * jm.prog(q, "rho"))
    aux = jm.update_auxiliary_state(jg, q, jnp.asarray(d["jaux"]), 0.0)
    g = np.random.default_rng(4).standard_normal(
        q.shape[:2] + (3, jm.grad_spec.num))
    gf = jm.compute_gradient_flux(jnp.asarray(g), q, aux, 0.0)
    return dict(q=q, aux=aux, gf=gf,
                jsrc=_sources(jcm, jls, example("bomex_les")),
                psrc=_sources(cm, pls, bomex_les))


@pytest.mark.parametrize("name", ["geostrophic", "subsidence",
                                  "rayleigh_sponge", "large_scale_process",
                                  "large_scale_subsidence", "linear_sponge",
                                  "bomex_geostrophic", "bomex_tendencies"])
def test_source_matches_jax(hadgem, forcing_state, name):
    jm, pm = hadgem["jm"], hadgem["pm"]
    s = forcing_state
    ref = s["jsrc"][name].contributions(jm, s["q"], s["gf"], s["aux"], 0.0)
    src = s["psrc"][name]
    got = src.contributions(pm, vm(s["q"]), vm(s["gf"]), vm(s["aux"]), 0.0)
    assert set(got) == set(ref) and ref
    for key, val in ref.items():
        g = got[key]
        g = nm(g) if g.dim() == 3 else g.numpy()
        val = np.asarray(val)
        assert np.max(np.abs(g - val)) <= 1e-12 * np.max(np.abs(val)), key
    if name in ("subsidence", "large_scale_process",
                "large_scale_subsidence", "bomex_tendencies"):
        assert src.contributions(pm, vm(s["q"]), None, vm(s["aux"]),
                                 0.0) == {}
    assert not src.on_var_major_rhs or name == "rayleigh_sponge"


def test_interop_carries_lsforcing_lanes(hadgem):
    from climatemachine_tpu_torch.interop import state_from_numpy
    d = hadgem
    names = (d["jm"].prog_spec.flattened_names(),
             d["jm"].aux_spec.flattened_names())
    assert "lsforcing.w_s" in names[1]
    q, aux = state_from_numpy(d["jq"], d["jaux"], device="cpu",
                              model=d["pm"], names=names)
    np.testing.assert_array_equal(nm(aux), d["jaux"])
