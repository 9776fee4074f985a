"""The port's turbulence closures, sponge, the moisture's and tracers'
gradient hooks and the temperature profiles against the JAX package's,
in float64 on the CPU (tests/les_parity.py: the rising bubble on the
3 × 3 × 3 LES box at p3).

Each closure (ConstantKinematicViscosity, ConstantDynamicViscosity,
SmagorinskyLilly, Vreman, AnisoMinDiss) on the same perturbed state and
aux: ``gradient_argument``, ``gradient_flux`` of a gradient made from a
numpy seed at the bubble's scales (so the buoyancy factor's clip is
taken at some nodes and not at others), ``viscosity`` and ``flux`` of
the JAX gradient flux, each within 1e-12 of the largest magnitude of the
JAX result; the same with an UpperAtmosSponge; the model's gradient
hooks with EquilMoist and NTracers; the aux lane ``turbulence.delta``
(2 J^(1/3)/N from the grid) within 1e-13; the profiles within 1e-13 of
each output's largest magnitude; ``Deardorff`` refused without the SGS
TKE model.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu import driver_api as jcm
from climatemachine_tpu.dg.spatial import \
    init_state_auxiliary as jax_init_aux
from climatemachine_tpu_torch import driver_api as cm
from climatemachine_tpu_torch.dg.spatial import init_state_auxiliary
from les_parity import grids, jax_model, nm, perturbed, port_model, vm

TOL = 1e-12
CLOSURES = {
    "ckv": lambda m: m.ConstantKinematicViscosity(50.0),
    "cdv": lambda m: m.ConstantDynamicViscosity(40.0),
    "smagorinsky": lambda m: m.SmagorinskyLilly(0.21),
    "vreman": lambda m: m.Vreman(0.21),
    "anisomindiss": lambda m: m.AnisoMinDiss(),
}
SPONGE = dict(z_max=1000.0, z_sponge=500.0, alpha_max=0.75, gamma=2.0)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def box():
    return grids(3, 3)


def _pair(box, jax_kw, port_kw):
    """Both models on the box, the JAX perturbed state and its updated
    aux (node-major) and the same as port tensors."""
    gj, gp = box
    mj, mp = jax_model(**jax_kw), port_model(**port_kw)
    dg = jcm.DGModel(mj, gj)
    q0, aux0 = jcm.init_ode_state(dg)
    q = jnp.asarray(perturbed(q0))
    aux = mj.update_auxiliary_state(gj, q, aux0, 0.0)
    return mj, mp, q, aux, vm(q), vm(aux)


def _grad(model, q, seed=3):
    """A gradient ``[E, Np, 3, ng]`` at the bubble's scales: ∇u ~ 1e-2
    /s, ∇h_tot ~ 10 J/kg/m, ∇θ_v ~ 3e-3 K/m (upward), ∇q_tot ~ 1e-6 /m,
    ∇χ ~ 1e-3 /m."""
    gs = model.grad_spec
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(q.shape[:2] + (3, gs.num))
    scale = np.ones(gs.num)
    for name, s in (("u", 1e-2), ("h_tot", 10.0), ("theta_v", 1e-3),
                    ("moisture.q_tot", 1e-6), ("tracers.chi", 1e-3)):
        try:
            scale[gs.index(name)] = s
        except KeyError:
            pass
    g = g * scale
    try:
        g[..., 2, gs.index("theta_v").start] += 3e-3
    except KeyError:
        pass
    return g


@pytest.fixture(scope="module", params=[(k, s) for k in CLOSURES
                                        for s in (False, True)],
                ids=[f"{k}{'-sponge' if s else ''}" for k in CLOSURES
                     for s in (False, True)])
def closure_case(request, box):
    key, sponge = request.param
    kw = lambda m: dict(turbulence=CLOSURES[key](m), sponge=(
        m.UpperAtmosSponge(**SPONGE) if sponge else None))
    mj, mp, q, aux, qp, auxp = _pair(box, kw(jcm), kw(cm))
    grad = _grad(mj, np.asarray(q))
    gf = mj.physics.turbulence.gradient_flux(mj, jnp.asarray(grad), q, aux,
                                             0.0)
    return mj, mp, q, aux, qp, auxp, grad, gf


def test_gradient_argument(closure_case):
    mj, mp, q, aux, qp, auxp, _, _ = closure_case
    _close(nm(mp.physics.turbulence.gradient_argument(mp, qp, auxp, 0.0)),
           mj.physics.turbulence.gradient_argument(mj, q, aux, 0.0))


def test_gradient_flux(closure_case):
    mj, mp, q, aux, qp, auxp, grad, gf = closure_case
    assert mp.gf_spec.flattened_names() == mj.gf_spec.flattened_names()
    got = mp.physics.turbulence.gradient_flux(mp, vm(grad), qp, auxp, 0.0)
    _close(nm(got), gf)


def test_viscosity(closure_case):
    mj, mp, q, aux, qp, auxp, _, gf = closure_case
    nu_j, dt_j = mj.physics.turbulence.viscosity(mj, q, gf, aux, 0.0)
    nu_p, dt_p = mp.physics.turbulence.viscosity(mp, qp, vm(gf), auxp, 0.0)
    _close(nm(nu_p), nu_j)
    _close(nm(dt_p), dt_j)


def test_flux(closure_case):
    mj, mp, q, aux, qp, auxp, _, gf = closure_case
    _close(nm(mp.physics.turbulence.flux(mp, qp, vm(gf), auxp, 0.0)),
           mj.physics.turbulence.flux(mj, q, gf, aux, 0.0))


def test_smagorinsky_buoyancy_clip_taken_both_ways(box):
    """The gradient of :func:`_grad` makes Ri/Pr_t cross 1 inside the box
    (the clip of f_b² taken at some nodes, not at others)."""
    mj, mp, q, aux, qp, auxp = _pair(
        box, dict(turbulence=jcm.SmagorinskyLilly(0.21)),
        dict(turbulence=cm.SmagorinskyLilly(0.21)))
    gf = mp.physics.turbulence.gradient_flux(mp, vm(_grad(mj, np.asarray(q))),
                                             qp, auxp, 0.0)
    from climatemachine_tpu_torch.common.turbulence import (
        _unpack_sym, strain_rate_magnitude)
    normS = strain_rate_magnitude(_unpack_sym(mp.gf_spec.get(gf, "S")))
    ri = mp.gf_spec.get(gf, "N2") / normS ** 2 * mp.param_set.inv_Pr_turb
    assert bool((ri > 1).any()) and bool((ri < 1).any())


def test_sponge_modify(box):
    mj, mp, q, aux, qp, auxp = _pair(box, {}, {})
    rng = np.random.default_rng(5)
    nu = rng.uniform(1.0, 2.0, np.asarray(q).shape[:2] + (3,))
    out_j = jcm.UpperAtmosSponge(**SPONGE).modify(mj, aux, jnp.asarray(nu),
                                                  2 * jnp.asarray(nu))
    out_p = cm.UpperAtmosSponge(**SPONGE).modify(mp, auxp, vm(nu),
                                                 2 * vm(nu))
    for got, ref in zip(out_p, out_j):
        _close(nm(got), ref)
    assert float(np.max(out_j[0] / nu)) > 1.5     # the layer is reached


@pytest.mark.parametrize("part", ["moist", "tracers"])
def test_model_gradient_hooks(box, part):
    """The model's gradient argument, gradient flux and second-order flux
    with EquilMoist (q_tot, ∇q_tot, −ρ D_t ∇q_tot on ρq_tot, ρ and ρu)
    or NTracers (χ, ∇χ, −ρ D_t δ_χ ∇χ) under SmagorinskyLilly."""
    extra = (dict(moisture=(jcm.EquilMoist(), cm.EquilMoist()))
             if part == "moist" else dict(tracers=(jcm.NTracers((1.0, 2.0)),
                                                  cm.NTracers((1.0, 2.0)))))
    kw = lambda i, m: dict(turbulence=m.SmagorinskyLilly(0.21),
                           **{k: v[i] for k, v in extra.items()})
    mj, mp, q, aux, qp, auxp = _pair(box, kw(0, jcm), kw(1, cm))
    assert mp.grad_spec.flattened_names() == mj.grad_spec.flattened_names()
    assert mp.gf_spec.flattened_names() == mj.gf_spec.flattened_names()
    _close(nm(mp.compute_gradient_argument(qp, auxp, 0.0)),
           mj.compute_gradient_argument(q, aux, 0.0))
    grad = _grad(mj, np.asarray(q))
    gf = mj.compute_gradient_flux(jnp.asarray(grad), q, aux, 0.0)
    _close(nm(mp.compute_gradient_flux(vm(grad), qp, auxp, 0.0)), gf)
    F_j = np.asarray(mj.flux_second_order(q, gf, None, aux, 0.0))
    F_p = nm(mp.flux_second_order(qp, vm(gf), None, auxp, 0.0))
    for v in range(F_j.shape[-1]):
        _close(F_p[..., v], F_j[..., v])


@pytest.mark.parametrize("key", ["smagorinsky", "ckv"])
def test_delta_from_grid(box, key):
    gj, gp = box
    mj = jax_model(turbulence=CLOSURES[key](jcm))
    mp = port_model(turbulence=CLOSURES[key](cm))
    assert mp.aux_spec.flattened_names() == mj.aux_spec.flattened_names()
    aux_j = np.asarray(jax_init_aux(mj, gj))
    aux_p = nm(init_state_auxiliary(mp, gp))
    _close(aux_p, aux_j, 1e-13)
    if key == "smagorinsky":
        sl = mp.aux_spec.index("turbulence.delta")
        np.testing.assert_allclose(
            aux_p[..., sl][..., 0], 2 * gp.J.numpy() ** (1 / 3) / 3,
            rtol=1e-14)


PROFILES = {
    "decaying": lambda m: m.DecayingTemperatureProfile(290.0, 220.0),
    "decaying_Ht": lambda m: m.DecayingTemperatureProfile(290.0, 220.0,
                                                          8e3),
    "isothermal": lambda m: m.IsothermalProfile(250.0),
    "dry_adiabatic": lambda m: m.DryAdiabaticProfile(300.0, 110.0),
    "dry_adiabatic_low": lambda m: m.DryAdiabaticProfile(290.0, 220.0),
}


@pytest.mark.parametrize("name", list(PROFILES))
def test_temperature_profiles(name):
    """(T_virt, p) from 0 to 30 km, past the dry adiabat's isothermal
    transition (19.4 km and 7.1 km)."""
    z = np.linspace(0.0, 3e4, 301)
    ref = PROFILES[name](jcm)(jcm.EARTH, jnp.asarray(z))
    got = PROFILES[name](cm)(cm.EARTH, torch.tensor(z))
    for g, r in zip(got, ref):
        _close(g.numpy(), r, 1e-13)


def test_deardorff_refused():
    """Deardorff builds (with the SGS TKE model it is a closure of
    tests/test_torch_sgstke.py); a model without ``sgstke`` is refused
    where the closure reads it."""
    closure = cm.Deardorff()
    assert closure.needs_delta and closure.viscosity_needs_gradient_flux
    model = port_model(turbulence=closure)
    with pytest.raises(ValueError, match="sgstke"):
        closure.viscosity(model, None, None, None, 0.0)
