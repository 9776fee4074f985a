"""The SGS TKE model, the Deardorff closure and the canopy sources in the
port against the JAX package, in float64 on the CPU:

- tests/test_turbulence.py:126's set-up (a triply periodic 1000 m brick
  at p4, NoOrientation, a sinusoidal shear u = sin(2πz/L), e_SGS = 0.1):
  the RHS at its state times 1 + 1e-3 · N(0, 1) within 1e-10 per
  variable, the JAX test's net TKE tendency check on the port, and 3
  LSRK54 steps within 1e-10 of the JAX package's;
- on the canopy case's small box (tests/forced_les_parity.py), dry and
  with EquilMoist, at a perturbed state, a gradient made from a numpy
  seed and the JAX gradient flux: the model's gradient hooks, the
  closure's ν and D_t, the SGS TKE's source, the second-order flux and
  the canopy sources' contributions, each within 1e-12 of the largest
  magnitude of the JAX result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu import driver_api as jcm
from climatemachine_tpu_torch import driver_api as cm
from climatemachine_tpu_torch.atmos.sgstke import SGStkeModel
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from forced_les_parity import CASES, var_err
from les_parity import nm, perturbed, vm

TOL = 1e-10
HOOK_TOL = 1e-12
L = 1000.0


def _close(got, ref, tol=HOOK_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= tol * np.max(np.abs(ref))


def _deardorff_port():
    """The port's model and grid of tests/test_turbulence.py:126."""
    ps = cm.EARTH
    T0, u0, e0, kz = 300.0, 1.0, 0.1, 2 * np.pi / L

    def init(m, coords, aux, t):
        z = coords[:, 2]
        rho = torch.full_like(z, 1.0)
        u = u0 * torch.sin(kz * z)
        e_int = cm.td.internal_energy(ps, torch.full_like(z, T0))
        return m.prog_spec.pack({
            "rho": rho, "rhoe": rho * (e_int + 0.5 * u ** 2),
            "sgstke.rhoe_SGS": rho * e0,
            "rhou": torch.stack([rho * u, torch.zeros_like(u),
                                 torch.zeros_like(u)], dim=1)})

    model = cm.AtmosModel(
        cm.AtmosPhysics(orientation=cm.NoOrientation(),
                        turbulence=cm.Deardorff(), sgstke=SGStkeModel()),
        cm.AtmosProblem(init_state=init,
                        boundary_conditions=(cm.AtmosBC(),) * 2))
    topo = cm.topology.brick_topology([np.linspace(0, L, 4)] * 3,
                                      periodicity=(True, True, True))
    return model, cm.make_grid(topo, 4, dtype=torch.float64, device="cpu")


def _deardorff_jax():
    """tests/test_turbulence.py:126's JAX model and grid (its body up to
    the DG model, as the test builds them)."""
    from climatemachine_tpu.atmos.sgstke import SGStkeModel as JaxSGS
    ps = jcm.EARTH
    T0, u0, e0, kz = 300.0, 1.0, 0.1, 2 * np.pi / L
    grid = jcm.make_grid(jcm.topology.brick_topology(
        [np.linspace(0, L, 4)] * 3, periodicity=(True, True, True)), 4,
        dtype=np.float64)

    def init(m, coords, aux, t):
        z = coords[..., 2]
        rho = jnp.full_like(z, 1.0)
        u = u0 * jnp.sin(kz * z)
        rhou = jnp.stack([rho * u, jnp.zeros_like(u), jnp.zeros_like(u)],
                         axis=-1)
        e_int = jcm.td.internal_energy(ps, jnp.full_like(z, T0))
        q = m.prog_spec.pack(
            {"rho": rho, "rhoe": rho * (e_int + 0.5 * u ** 2),
             "sgstke.rhoe_SGS": rho * e0}, batch_shape=rho.shape)
        return m.prog_spec.set(q, "rhou", rhou)

    model = jcm.AtmosModel(
        jcm.AtmosPhysics(orientation=jcm.NoOrientation(),
                         turbulence=jcm.Deardorff(), sgstke=JaxSGS()),
        jcm.AtmosProblem(init_state=init,
                         boundary_conditions=(jcm.AtmosBC(),) * 2))
    return model, grid


@pytest.fixture(scope="module")
def deardorff():
    jm, jg = _deardorff_jax()
    jdg = jcm.DGModel(jm, jg)
    q0, aux0 = jcm.init_ode_state(jdg)
    m, g = _deardorff_port()
    dg = DGModel(m, g)
    q, aux = init_ode_state(dg)
    rhs = jax.jit(lambda a, b, t: jdg(a, b, t))
    return dict(jq=np.asarray(q0), jaux=np.asarray(aux0), rhs=rhs, dg=dg,
                q=q, aux=aux, model=m, grid=g)


def test_deardorff_setup_init_and_rhs(deardorff):
    d = deardorff
    assert np.all(var_err(nm(d["q"]), d["jq"]) <= 1e-12)
    qp = perturbed(d["jq"], seed=0)
    ref = np.asarray(d["rhs"](jnp.asarray(qp), jnp.asarray(d["jaux"]),
                              0.0)[0])
    got = nm(d["dg"](vm(qp), vm(d["jaux"]), 0.0)[0])
    err = var_err(got, ref)
    assert np.all(err <= TOL), err


def test_deardorff_setup_tke_tendency(deardorff):
    """tests/test_turbulence.py:157-167 on the port: with weak shear the
    dissipation dominates, the net TKE tendency negative and of the
    analytic magnitude."""
    d = deardorff
    m, g = d["model"], d["grid"]
    tend, _ = d["dg"](d["q"], d["aux"], 0.0)
    assert bool(torch.isfinite(tend).all())
    net = torch.sum(g.M * m.prog_spec.get(tend, "sgstke.rhoe_SGS")).item()
    vol = torch.sum(g.M).item()
    delta = m.aux_spec.get(d["aux"], "turbulence.delta").max().item()
    diss_est = -0.7 * 0.1 ** 1.5 / delta * vol
    assert diss_est * 3 < net < 0.0, (net, diss_est)


def test_deardorff_setup_steps(deardorff):
    """3 LSRK54 steps of the port against the JAX package's (its stages
    eager around the jitted RHS), dt = 0.3 Δx_min / 360 as the JAX test
    takes it."""
    from climatemachine_tpu.ode.lsrk import LSRK54CarpenterKennedy as JLSRK
    d = deardorff
    dt = 0.3 * cm.min_node_distance(d["grid"]) / 360.0
    jsolver = JLSRK(lambda a, b, t: d["rhs"](a, b, float(t)), dt)
    solver = cm.LSRK54CarpenterKennedy(d["dg"], dt)
    jq, jaux = jnp.asarray(d["jq"]), jnp.asarray(d["jaux"])
    q, aux = vm(d["jq"]), vm(d["jaux"])
    for i in range(3):
        jq, jaux = jsolver.step(jq, jaux, i * dt)
        q, aux = solver.step(q, aux, i * dt)
    err = var_err(nm(q), np.asarray(jq))
    assert np.all(err <= TOL), err


def _scaled_gradient(model, shape, seed=3):
    """A gradient ``[E, Np, 3, ng]`` at a boundary layer's scales, θ
    and θ_li rising upward."""
    gs = model.grad_spec
    g = np.random.default_rng(seed).standard_normal(shape + (3, gs.num))
    scale = np.ones(gs.num)
    for name, s in (("u", 1e-2), ("h_tot", 10.0), ("moisture.q_tot", 1e-6),
                    ("tracers.chi", 1e-6), ("sgstke.e_SGS", 1e-3),
                    ("sgstke.theta_li", 1e-3)):
        try:
            scale[gs.index(name)] = s
        except KeyError:
            pass
    g = g * scale
    g[..., 2, gs.index("sgstke.theta_li").start] += 3e-3
    return g


@pytest.fixture(scope="module", params=["canopy_dry", "canopy_equilibrium"])
def canopy(request):
    case = CASES[request.param]
    res, dom = case["box"]
    jm = case["jax"]()
    jg = jcm.AtmosLESConfiguration("c", 4, res, *dom, jm,
                                   dtype=np.float64).grid
    q0, aux0 = jcm.init_ode_state(jcm.DGModel(jm, jg))
    q = jnp.asarray(perturbed(q0, seed=1))
    aux = jm.update_auxiliary_state(jg, q, aux0, 0.0)
    pm = case["port"](res, dom).model
    grad = _scaled_gradient(jm, q.shape[:2])
    gf = jm.compute_gradient_flux(jnp.asarray(grad), q, aux, 0.0)
    return dict(jm=jm, pm=pm, q=q, aux=aux, grad=grad, gf=gf, qp=vm(q),
                auxp=vm(aux), gfp=vm(gf))


def test_gradient_hooks_match_jax(canopy):
    c = canopy
    jm, pm = c["jm"], c["pm"]
    for spec in ("grad_spec", "gf_spec"):
        assert list(getattr(pm, spec).flattened_names()) == list(
            getattr(jm, spec).flattened_names())
    _close(nm(pm.compute_gradient_argument(c["qp"], c["auxp"], 0.0)),
           jm.compute_gradient_argument(c["q"], c["aux"], 0.0))
    _close(nm(pm.compute_gradient_flux(vm(c["grad"]), c["qp"], c["auxp"],
                                       0.0)), c["gf"])


def test_deardorff_viscosity_matches_jax(canopy):
    c = canopy
    nu_j, dt_j = c["jm"].physics.turbulence.viscosity(c["jm"], c["q"],
                                                      c["gf"], c["aux"], 0.0)
    nu_p, dt_p = c["pm"].physics.turbulence.viscosity(
        c["pm"], c["qp"], c["gfp"], c["auxp"], 0.0)
    _close(nm(nu_p), nu_j)
    _close(nm(dt_p), dt_j)


def test_sgstke_source_matches_jax(canopy):
    c = canopy
    ref = c["jm"].physics.sgstke.source(c["jm"], c["q"], c["gf"], c["aux"],
                                        0.0)
    got = c["pm"].physics.sgstke.source(c["pm"], c["qp"], c["gfp"],
                                        c["auxp"], 0.0)
    _close(got.numpy(), ref)


def test_flux_second_order_matches_jax(canopy):
    c = canopy
    ref = np.asarray(c["jm"].flux_second_order(c["q"], c["gf"], None,
                                               c["aux"], 0.0))
    got = c["pm"].flux_second_order(c["qp"], c["gfp"], None, c["auxp"], 0.0)
    got = got.permute(0, 3, 1, 2).numpy()          # [E, Np, 3, n]
    for v in range(ref.shape[-1]):
        if np.max(np.abs(ref[..., v])) > 0:
            _close(got[..., v], ref[..., v])


@pytest.mark.parametrize("source", [1, 2], ids=["aerodynamics",
                                                "atmo_interaction"])
def test_canopy_source_matches_jax(canopy, source):
    c = canopy
    ref = c["jm"].sources[source].contributions(c["jm"], c["q"], c["gf"],
                                                c["aux"], 0.0)
    got = c["pm"].sources[source].contributions(c["pm"], c["qp"], c["gfp"],
                                                c["auxp"], 0.0)
    assert set(got) == set(ref)
    for name, val in ref.items():
        _close(nm(got[name]) if got[name].dim() == 3
               else got[name].numpy(), val)


def test_interop_carries_sgstke_lane(canopy):
    from climatemachine_tpu_torch.interop import state_from_numpy
    c = canopy
    names = (c["jm"].prog_spec.flattened_names(),
             c["jm"].aux_spec.flattened_names())
    assert "sgstke.rhoe_SGS" in names[0]
    q, _ = state_from_numpy(np.asarray(c["q"]), np.asarray(c["aux"]),
                            device="cpu", model=c["pm"], names=names)
    np.testing.assert_array_equal(nm(q), np.asarray(c["q"]))
