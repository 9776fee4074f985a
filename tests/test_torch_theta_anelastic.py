"""The port's ρθ formulation (``ThetaModel``) and 1-D anelastic
constraint (``Anelastic1D``) against the JAX package's on the CPU in
float64: the rising bubble of tests/test_atmos_extras.py's
``test_theta_model_bubble`` (no closure: the generic operator's
first-order path) and the box of its ``test_anelastic1d`` (the port's
experiments/anelastic1d.py; ConstantKinematicViscosity(1): the gradient
path), both on that file's ``_grid(nz=4, poly=4)`` (3 × 3 × 4
elements): the initial state (for Anelastic1D ρ = ρ_ref and the
thermodynamic pressure = the reference pressure), one RHS at the JAX
initial state times 1 + 1e-3 · N(0, 1) from a numpy seed, and 3 LSRK54
steps from the JAX initial state at the JAX test's dt, each within TOL
per variable (the momentum's components over the largest); also the
defaults and the checks of ``AtmosPhysics``, and the var-major RHS's
and the fast surface pass's refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu import driver_api as jcm
from climatemachine_tpu.atmos.compressibility import Anelastic1D as JAnel
from climatemachine_tpu.atmos.energy import ThetaModel as JTheta
from climatemachine_tpu.mesh.grid import min_node_distance as jmnd
from climatemachine_tpu.physics import thermodynamics as jtd
from climatemachine_tpu_torch import driver_api as cm
from climatemachine_tpu_torch.dg import fast_rhs, fast_surface
from climatemachine_tpu_torch.dg.reductions import weightedsum
from climatemachine_tpu_torch.experiments import anelastic1d
from les_parity import nm, perturbed, vm
from test_atmos_extras import _grid

TOL = 1e-10
EXACT_TOL = 1e-14
N_STEPS = 3
PS = jcm.EARTH


def rel_err_per_var(got, ref):
    """max|got − ref| per variable over max|ref| of it, the momentum's
    components over the largest, 1 where the reference is 0 (a state at
    rest)."""
    axes = tuple(range(ref.ndim - 1))
    scale = np.max(np.abs(ref), axis=axes)
    scale[1:4] = scale[1:4].max()
    return np.max(np.abs(got - ref), axis=axes) / np.where(scale > 0, scale,
                                                           1.0)


def jax_theta_model():
    physics = jcm.AtmosPhysics(
        ref_state=jcm.HydrostaticState(jcm.DryAdiabaticProfile(300.0,
                                                               110.0)),
        energy=JTheta())

    def init(m, coords, aux, t):
        x, z = coords[..., 0], coords[..., 2]
        p = m.aux_spec.get(aux, "ref_state.p")
        r = jnp.sqrt((x - 500.0) ** 2 + (z - 300.0) ** 2)
        theta = 300.0 + 2.0 * jnp.clip(1 - r / 200.0, 0.0, 1.0)
        T = theta * (p / PS.MSLP) ** PS.kappa_d
        rho = p / (PS.R_d * T)
        return m.prog_spec.pack({"rho": rho, "rhoe": rho * theta},
                                batch_shape=rho.shape)

    return jcm.AtmosModel(physics, jcm.AtmosProblem(init_state=init),
                          sources=(jcm.Gravity(),))


def port_theta_model():
    physics = cm.AtmosPhysics(
        ref_state=cm.HydrostaticState(cm.DryAdiabaticProfile(300.0, 110.0)),
        energy=cm.ThetaModel())

    def init(m, coords, aux, t):
        x, z = coords[:, 0], coords[:, 2]
        p = m.aux_spec.get(aux, "ref_state.p")
        r = torch.sqrt((x - 500.0) ** 2 + (z - 300.0) ** 2)
        theta = 300.0 + 2.0 * torch.clamp(1 - r / 200.0, 0.0, 1.0)
        T = theta * (p / PS.MSLP) ** PS.kappa_d
        rho = p / (PS.R_d * T)
        return m.prog_spec.pack({"rho": rho, "rhoe": rho * theta})

    return cm.AtmosModel(physics, cm.AtmosProblem(init_state=init),
                         sources=(cm.Gravity(),))


def jax_anelastic_model():
    physics = jcm.AtmosPhysics(
        ref_state=jcm.HydrostaticState(jcm.DryAdiabaticProfile(300.0,
                                                               110.0)),
        turbulence=jcm.ConstantKinematicViscosity(1.0),
        compressibility=JAnel())

    def init(m, coords, aux, t):
        x = coords[..., 0]
        p = m.aux_spec.get(aux, "ref_state.p")
        Phi = m.aux_spec.get(aux, "orientation.Phi")
        T = 300.0 * (p / PS.MSLP) ** PS.kappa_d \
            + 0.5 * jnp.sin(2 * np.pi * x / 1000.0)
        rho = jnp.ones_like(p)
        u = 2.0 * jnp.cos(2 * np.pi * x / 1000.0)
        q = m.prog_spec.pack(
            {"rho": rho,
             "rhoe": rho * (jtd.internal_energy(PS, T) + Phi
                            + 0.5 * u ** 2)},
            batch_shape=rho.shape)
        return m.prog_spec.set(
            q, "rhou", jnp.stack([rho * u, 0 * u, 0 * u], axis=-1))

    return jcm.AtmosModel(physics, jcm.AtmosProblem(init_state=init),
                          sources=(jcm.Gravity(),))


def run(case):
    """Both packages' ``case`` ("theta" or "anelastic"): node-major
    initial states, RHS and states after N_STEPS steps, the port's model,
    grid and initial aux."""
    jgrid = _grid(nz=4, poly=4)
    if case == "theta":
        jmodel, model = jax_theta_model(), port_theta_model()
        grid = cm.make_grid(cm.topology.stacked_brick_topology(
            [np.linspace(0, 1000.0, 4)] * 2 + [np.linspace(0, 1000.0, 5)],
            (True, True, False), np.array([[0, 0], [0, 0], [1, 2]])), 4,
            dtype=torch.float64, device="cpu")
        dg = cm.DGModel(model, grid)
        q0, aux0 = cm.init_ode_state(dg)
        dt = 0.3 * jmnd(jgrid) / 360.0
        solver = lambda rhs: cm.LSRK54CarpenterKennedy(rhs, dt)
    else:
        jmodel = jax_anelastic_model()
        model, dg, grid, q0, aux0 = anelastic1d.anelastic_box("cpu")
        step, dt = anelastic1d.stepper(dg, grid)
        assert abs(dt - 0.2 * jmnd(jgrid) / 4.0) <= 1e-15 * dt
        solver = lambda rhs: cm.LSRK54CarpenterKennedy(rhs, dt)
    jdg = jcm.DGModel(jmodel, jgrid)
    jq0, jaux0 = jcm.init_ode_state(jdg)
    jrhs = jax.jit(lambda a, b, t: jdg(a, b, t))
    qp = jnp.asarray(perturbed(jq0, seed=0))
    out = dict(model=model, grid=grid, aux0=aux0, jmodel=jmodel,
               jaux0=jaux0, port_q0=nm(q0), jax_q0=np.asarray(jq0),
               jax_rhs=np.asarray(jrhs(qp, jaux0, 0.0)[0]),
               port_rhs=nm(dg(vm(qp), vm(jaux0), 0.0)[0]))
    jstep = jcm.LSRK54CarpenterKennedy(jrhs, dt).step
    pstep = solver(dg).step
    jq, jx, q, x = jq0, jaux0, vm(jq0), vm(jaux0)
    for i in range(N_STEPS):
        jq, jx = jstep(jq, jx, i * dt)
        q, x = pstep(q, x, i * dt)
    out.update(jax_q=np.asarray(jq), port_q=nm(q), port_q_t=q)
    return out


@pytest.fixture(scope="module", params=["theta", "anelastic"])
def case(request):
    return request.param, run(request.param)


def test_initial_state_matches_jax(case):
    name, out = case
    err = rel_err_per_var(out["port_q0"], out["jax_q0"])
    assert np.all(err <= EXACT_TOL), err


def test_rhs_matches_jax(case):
    name, out = case
    err = rel_err_per_var(out["port_rhs"], out["jax_rhs"])
    assert np.all(err <= TOL), err


def test_steps_match_jax(case):
    name, out = case
    err = rel_err_per_var(out["port_q"], out["jax_q"])
    assert np.all(err <= TOL), err
    assert np.all(np.isfinite(out["port_q"]))


def test_conservation_and_constraints(case):
    """θ: ∫ρ and ∫ρθ conserved to round-off; Anelastic1D: ρ = ρ_ref and
    p = p_ref initially and after the steps, ρw never moves."""
    name, out = case
    model, grid, q = out["model"], out["grid"], out["port_q_t"]
    q0 = vm(out["jax_q0"])
    if name == "theta":
        for lane in (0, 4):
            m0 = weightedsum(grid, q0, lane).item()
            m1 = weightedsum(grid, q, lane).item()
            assert abs(m1 - m0) <= 1e-12 * abs(m0), lane
        return
    aux = out["aux0"]
    rho_ref = model.aux_spec.get(aux, "ref_state.rho")
    p_ref = model.aux_spec.get(aux, "ref_state.p")
    for state in (vm(out["port_q0"]), q):
        sp = model.prog_spec
        assert float(((sp.get(state, "rho") - rho_ref).abs()
                      / rho_ref).max()) <= EXACT_TOL
        _, p = model.thermo(state, model.update_auxiliary_state(state, aux,
                                                                grid))
        assert float(((p - p_ref).abs() / p_ref).max()) <= EXACT_TOL
    assert float(model.prog_spec.get(q, "rhou")[:, 2].abs().max()) < 1e-10


def test_physics_defaults_match_jax():
    """``AtmosPhysics()`` gives total energy and compressible flow, as the
    JAX package's model does."""
    phys = cm.AtmosPhysics()
    assert type(phys.energy) is cm.TotalEnergyModel
    assert type(phys.compressibility) is cm.Compressible
    jm = jcm.AtmosModel(jcm.AtmosPhysics(), jcm.AtmosProblem())
    assert type(jm.physics.energy).__name__ == "TotalEnergyModel"
    assert type(jm.physics.compressibility).__name__ == "Compressible"
    m = cm.AtmosModel(phys, cm.AtmosProblem())
    assert not m.physics.energy.is_theta
    assert not m.physics.compressibility.is_anelastic


@pytest.mark.parametrize("physics", [
    dict(energy=cm.ThetaModel(), moisture=cm.EquilMoist()),
    dict(compressibility=cm.Anelastic1D(), energy=cm.ThetaModel(),
         ref_state=cm.HydrostaticState(cm.DryAdiabaticProfile(300.0,
                                                              110.0))),
    dict(compressibility=cm.Anelastic1D())])
def test_physics_checks(physics):
    """ThetaModel is dry only; Anelastic1D needs TotalEnergyModel and a
    hydrostatic reference state (the JAX package asserts the same)."""
    with pytest.raises(ValueError):
        cm.AtmosModel(cm.AtmosPhysics(**physics), cm.AtmosProblem())


def test_fast_paths_refuse(case):
    """The var-major RHS and the fast surface pass refuse both
    formulations, naming the generic operator; "auto" takes it."""
    name, out = case
    dg = cm.DGModel(out["model"], out["grid"])
    assert not fast_rhs.supports(dg) and not fast_surface.supports(dg)
    assert not dg.dry_volume and not dg.fast_surface
    with pytest.raises(ValueError, match="generic"):
        fast_rhs.VarMajorRHS(dg)
    with pytest.raises(ValueError, match="generic"):
        fast_surface.surface_tendency(dg, vm(out["port_q0"]), out["aux0"],
                                      0.0)
