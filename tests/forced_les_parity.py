"""Shared set-up of the forced-LES parity tests (test_torch_bomex*.py,
test_torch_dycoms.py, test_torch_boundary_layers.py,
test_torch_canopy_sgstke.py): each case built in both packages through
the driver entry on a small box (2 × 2 × 2 elements at p4, float64, the
port on the CPU), the JAX side as its example's ``main`` builds it (the
init functions that the examples define inside ``main`` are copied
here), the port side from ``climatemachine_tpu_torch.experiments``.

What the tests hold, per case:
- the initial state of each package's init within ``init_tol`` per
  variable (relative to its largest magnitude): the cases whose init
  bisects T from θ_liq (``temperature_from_theta_liq``, 30 halvings of
  [T_min, T_max]) within 2 (T_max − T_min)/2³⁰ / T_LOW (a comparison that
  flips on round-off moves T by the last bracket, at most
  ``BRACKET_T``; T_LOW = 250 K lies below every T of these boxes), the
  others within 1e-12;
- the aux of ``init_ode_state`` within TOL = 1e-10 per lane, and one
  RHS within TOL per variable at the JAX initial state times 1 + 1e-3 ·
  N(0, 1) from a numpy seed (at the initial state itself some
  tendencies, such as ρ's in a horizontally uniform flow, are round-off
  alone), carried across;
- dt from ``calculate_dt`` at the JAX initial state within 1e-12
  relative;
- ``invoke``'s N_STEPS steps from the JAX initial state and dt, with
  BOMEX's TMAR callback, within TOL per variable, and its norm ratio.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from climatemachine_tpu import driver_api as jcm
from climatemachine_tpu_torch import driver_api as cm
from climatemachine_tpu_torch.experiments import (
    bomex_les, boundary_layer_les, canopy_sgstke, dycoms)
from les_parity import nm, perturbed, rel_err_per_var, vm

TOL = 1e-10
N_STEPS = 3
PS = jcm.EARTH
BRACKET_T = (PS.T_max - PS.T_min) / 2 ** 30
T_LOW = 250.0
BISECT_INIT_TOL = 2 * BRACKET_T / T_LOW
EXACT_INIT_TOL = 1e-12
EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def var_err(got, ref):
    """``rel_err_per_var`` (the momentum's components over the largest)
    with a scale of 1 where the reference variable is 0 (a state at
    rest)."""
    axes = tuple(range(ref.ndim - 1))
    scale = np.max(np.abs(ref), axis=axes)
    scale[1:4] = scale[1:4].max()
    return np.max(np.abs(got - ref), axis=axes) / np.where(scale > 0, scale,
                                                           1.0)


def lane_err(got, ref):
    """max|got − ref| per lane (last axis) over max|ref| of it, or over 1
    where the reference lane is 0 (∇Φ's horizontal lanes)."""
    axes = tuple(range(ref.ndim - 1))
    scale = np.max(np.abs(ref), axis=axes)
    return np.max(np.abs(got - ref), axis=axes) / np.where(scale > 0, scale,
                                                           1.0)


def example(name):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- the JAX package's models, as each example's ``main`` builds them ------

def jax_bomex(surface_flux):
    ex = example("bomex_les")
    zmax = 3000.0
    physics = jcm.AtmosPhysics(
        ref_state=jcm.HydrostaticState(
            jcm.DecayingTemperatureProfile(290.0, 220.0)),
        turbulence=jcm.SmagorinskyLilly(ex.C_SMAG),
        moisture=jcm.EquilMoist(maxiter=5))
    if surface_flux == "prescribed":
        energy_bc = jcm.PrescribedEnergyFlux(
            lambda m, q, a, t: ex.LHF + ex.SHF)
        moist_bc = jcm.PrescribedMoistureFlux(
            lambda m, q, a, t: ex.LHF / jcm.td.latent_heat_vapor(
                PS, ex.T_SFC))
    else:
        energy_bc = jcm.BulkFormulaEnergy(
            C_h=lambda m, q, a, t, speed: 0.0011, T_sfc=lambda t: ex.T_SFC)
        moist_bc = jcm.BulkFormulaMoisture(C_q=0.0011, q_tot_sfc=ex.Q_SFC)
    bc_bottom = jcm.AtmosBC(
        momentum=jcm.Impenetrable(jcm.DragLaw(
            lambda m, q, a, t, speed: (ex.U_STAR / speed) ** 2)),
        energy=energy_bc, moisture=moist_bc)
    return jcm.AtmosModel(
        physics,
        jcm.AtmosProblem(init_state=ex.init_bomex,
                         boundary_conditions=(bc_bottom, jcm.AtmosBC())),
        sources=(jcm.Gravity(), ex.BomexTendencies(zmax),
                 ex.BomexSponge(zmax), ex.BomexGeostrophic(zmax)))


def jax_dycoms():
    ps, z_i = PS, 840.0
    LHF, SHF, C_drag, D_sub = 115.0, 15.0, 0.0011, 3.75e-6
    u_geo, v_geo, f_cor = 7.0, -5.5, 7.62e-5
    rad = jcm.DYCOMSRadiationModel(kappa=85.0, alpha_z=1.0, z_i=z_i,
                                   rho_i=1.13, D_subsidence=D_sub,
                                   F_0=70.0, F_1=22.0)
    physics = jcm.AtmosPhysics(
        ref_state=jcm.HydrostaticState(
            jcm.DecayingTemperatureProfile(289.0, 220.0)),
        turbulence=jcm.SmagorinskyLilly(0.21), moisture=jcm.EquilMoist(),
        radiation=rad)

    def init(m, coords, aux, t):
        s = m.aux_spec
        pr = s.get(aux, "ref_state.p")
        Phi = s.get(aux, "orientation.Phi")
        z = coords[..., 2]
        below = z <= z_i
        theta_liq = jnp.where(below, 289.0,
                              297.5 + jnp.cbrt(jnp.maximum(z - z_i, 0.0)))
        q_tot = jnp.where(below, 9.0e-3, 1.5e-3)
        T = jcm.td.temperature_from_theta_liq(ps, pr, theta_liq, q_tot)
        pphase = jcm.td.PhasePartition(q_tot, jnp.zeros_like(q_tot),
                                       jnp.zeros_like(q_tot))
        rho = pr / (jcm.td.gas_constant_air(ps, pphase) * T)
        u = jnp.stack([jnp.full_like(z, u_geo), jnp.full_like(z, v_geo),
                       jnp.zeros_like(z)], axis=-1)
        ke = 0.5 * jnp.sum(u * u, axis=-1)
        rhoe = rho * (jcm.td.internal_energy(ps, T, pphase) + ke + Phi)
        q = m.prog_spec.pack({"rho": rho, "rhoe": rhoe},
                             batch_shape=rho.shape)
        q = m.prog_spec.set(q, "rhou", rho[..., None] * u)
        return m.prog_spec.set(q, "moisture.rhoq_tot", rho * q_tot)

    bc_bottom = jcm.AtmosBC(
        momentum=jcm.Impenetrable(jcm.DragLaw(C_drag)),
        energy=jcm.PrescribedEnergyFlux(LHF + SHF),
        moisture=jcm.PrescribedMoistureFlux(
            lambda m, q, aux, t: LHF / ps.LH_v0))
    return jcm.AtmosModel(
        physics,
        jcm.AtmosProblem(init_state=init,
                         boundary_conditions=(bc_bottom, jcm.AtmosBC())),
        sources=(jcm.Gravity(),
                 jcm.GeostrophicForcing(f_cor, u_geo, v_geo),
                 jcm.Subsidence(D_sub),
                 jcm.RayleighSponge(z_max=1500.0, z_sponge=1125.0,
                                    alpha_max=1.0,
                                    u_relaxation=(u_geo, v_geo, 0.0))))


def jax_convective_bl():
    ps, C_drag, u_geo, v_geo, f_cor, zmax = PS, 0.001, 4.0, 0.0, 1.031e-4, \
        3200.0
    physics = jcm.AtmosPhysics(
        ref_state=jcm.HydrostaticState(
            jcm.DecayingTemperatureProfile(290.0, 220.0)),
        turbulence=jcm.SmagorinskyLilly(0.23))

    def init(m, coords, aux, t):
        z = coords[..., 2]
        theta = 288.0 + 4.0e-3 * z
        exner = 1.0 - ps.grav / (ps.cp_d * theta) * z
        rho = (ps.MSLP / (ps.R_d * theta)
               * exner ** (ps.cv_d / ps.R_d))
        T = theta * exner
        Phi = m.aux_spec.get(aux, "orientation.Phi")
        rhoe = rho * (jcm.td.internal_energy(ps, T) + Phi)
        return m.prog_spec.pack({"rho": rho, "rhoe": rhoe},
                                batch_shape=rho.shape)

    def surface_T(model, q, aux, t):
        theta_sfc = 291.15 + 20.0 * jnp.sin(jnp.pi * t / (12 * 3600.0))
        rho = model.prog(q, "rho")
        return theta_sfc * (rho * ps.R_d * theta_sfc / ps.MSLP) \
            ** (ps.R_d / ps.cv_d)

    bc_bottom = jcm.AtmosBC(
        momentum=jcm.Impenetrable(jcm.DragLaw(C_drag)),
        energy=jcm.BulkFormulaEnergy(
            C_h=lambda model, q, aux, t, speed: C_drag, T_sfc=surface_T))
    return jcm.AtmosModel(
        physics,
        jcm.AtmosProblem(init_state=init,
                         boundary_conditions=(bc_bottom, jcm.AtmosBC())),
        sources=(jcm.Gravity(),
                 jcm.GeostrophicForcing(f_cor, u_geo, v_geo),
                 jcm.RayleighSponge(z_max=zmax, z_sponge=2560.0,
                                    alpha_max=0.75,
                                    u_relaxation=(u_geo, v_geo, 0.0))))


def jax_stable_bl(surface_flux):
    ex = example("stable_bl_les")
    ps, u_star, C_drag = PS, 0.30, 0.0044
    u_geo, v_geo, f_cor, zmax = 8.0, 0.0, 1.39e-4, 400.0
    physics = jcm.AtmosPhysics(
        ref_state=jcm.HydrostaticState(
            jcm.DecayingTemperatureProfile(290.0, 220.0)),
        turbulence=jcm.ConstantKinematicViscosity(0.0))

    def init(m, coords, aux, t):
        z = coords[..., 2]
        theta = jnp.where(z <= 100.0, 265.0,
                          265.0 + 0.01 * jnp.maximum(z - 100.0, 0.0))
        pr = m.aux_spec.get(aux, "ref_state.p")
        Phi = m.aux_spec.get(aux, "orientation.Phi")
        exner = (pr / ps.MSLP) ** ps.kappa_d
        T = theta * exner
        rho = pr / (ps.R_d * T)
        u = jnp.stack([jnp.full_like(z, u_geo), jnp.zeros_like(z),
                       jnp.zeros_like(z)], axis=-1)
        ke = 0.5 * jnp.sum(u * u, axis=-1)
        rhoe = rho * (jcm.td.internal_energy(ps, T) + ke + Phi)
        q = m.prog_spec.pack({"rho": rho, "rhoe": rhoe},
                             batch_shape=rho.shape)
        return m.prog_spec.set(q, "rhou", rho[..., None] * u)

    def drag_coef(model, q, aux, t, speed):
        return (u_star / jnp.maximum(speed, 1e-4)) ** 2

    if surface_flux == "bulk":
        energy_bc = jcm.BulkFormulaEnergy(
            C_h=lambda model, q, aux, t, speed: C_drag,
            T_sfc=lambda t: ex.surface_temperature(t))
    else:
        energy_bc = jcm.PrescribedTemperature(
            T_sfc=lambda t: ex.surface_temperature(t))
    bc_bottom = jcm.AtmosBC(
        momentum=jcm.Impenetrable(jcm.DragLaw(drag_coef)), energy=energy_bc)
    return jcm.AtmosModel(
        physics,
        jcm.AtmosProblem(init_state=init,
                         boundary_conditions=(bc_bottom, jcm.AtmosBC())),
        sources=(jcm.Gravity(),
                 jcm.GeostrophicForcing(f_cor, u_geo, v_geo),
                 jcm.RayleighSponge(z_max=zmax, z_sponge=300.0,
                                    alpha_max=0.75,
                                    u_relaxation=(u_geo, v_geo, 0.0))))


def jax_canopy(moisture):
    from climatemachine_tpu.atmos.canopy import (CanopyAerodynamics,
                                                 CanopyAtmoInteraction)
    from climatemachine_tpu.atmos.sgstke import SGStkeModel
    ps = PS
    c_d, LAI, h_c, G_veg, GPP = 0.2, 2.0, 20.0, 0.2, 1.0
    dz, C_drag, LHF, SHF, ugeo, q_tot0 = CANOPY_RES[2], 0.0011, 50.0, \
        15.0, 5.0, 1e-3
    dry = moisture == "dry"
    physics = jcm.AtmosPhysics(
        ref_state=jcm.HydrostaticState(jcm.DryAdiabaticProfile(300.0, 0.0)),
        turbulence=jcm.Deardorff(),
        moisture=jcm.DryModel() if dry else jcm.EquilMoist(maxiter=5),
        tracers=jcm.NTracers((1.6e-5,)), sgstke=SGStkeModel())

    def init(m, coords, aux, t):
        z = coords[..., 2]
        theta = jnp.where(z <= 2 * h_c, 300.0,
                          300.0 - 3e-3 * (z - 2 * h_c))
        Phi = m.aux_spec.get(aux, "orientation.Phi")
        if dry:
            exner = 1.0 - ps.grav / (ps.cp_d * theta) * z
            rho = (ps.MSLP / (ps.R_d * theta)
                   * exner ** (ps.cv_d / ps.R_d))
            T = theta * exner
            e_int = jcm.td.internal_energy(ps, T)
        else:
            pp = jcm.td.PhasePartition.vapor(jnp.full_like(z, q_tot0))
            Rm = jcm.td.gas_constant_air(ps, pp)
            H = Rm * 300.0 / ps.grav
            pz = ps.MSLP * jnp.exp(-z / H)
            exner = (pz / ps.MSLP) ** (ps.kappa_d)
            T = theta * exner
            rho = pz / (Rm * T)
            e_int = jcm.td.internal_energy(ps, T, pp)
        e_kin = 0.5 * ugeo ** 2
        fields = {"rho": rho, "rhoe": rho * (e_int + e_kin + Phi),
                  "sgstke.rhoe_SGS": rho * 0.2 * e_kin,
                  "tracers.rhochi": (3.4e-4 * rho)[..., None]}
        if not dry:
            fields["moisture.rhoq_tot"] = rho * q_tot0
        q = m.prog_spec.pack(fields, batch_shape=rho.shape)
        rhou = jnp.stack([rho * ugeo, jnp.zeros_like(rho),
                          jnp.zeros_like(rho)], axis=-1)
        return m.prog_spec.set(q, "rhou", rhou)

    moisture_bc = {} if dry else {
        "moisture": jcm.PrescribedMoistureFlux(
            lambda model, q, aux, t: LHF / ps.LH_v0)}
    bc_bottom = jcm.AtmosBC(
        momentum=jcm.Impenetrable(jcm.DragLaw(C_drag)),
        energy=jcm.PrescribedEnergyFlux(lambda model, q, aux, t: LHF + SHF),
        **moisture_bc)
    return jcm.AtmosModel(
        physics,
        jcm.AtmosProblem(init_state=init,
                         boundary_conditions=(bc_bottom, jcm.AtmosBC())),
        sources=(jcm.Gravity(), CanopyAerodynamics(c_d, h_c, LAI, dz),
                 CanopyAtmoInteraction(h_c, LAI, dz, G_veg, GPP)))


# --- the cases: (JAX model, port config, box, Courant, JAX solver type) ---

CANOPY_RES = (12.5, 12.5, 12.5)
CASES = {
    "bomex_prescribed": dict(
        jax=lambda: jax_bomex("prescribed"), bisect=True, courant=0.35,
        box=((800.0, 800.0, 375.0), (6400.0, 6400.0, 3000.0)),
        port=lambda res, dom: bomex_les.bomex_config(
            res, dom, "prescribed", device="cpu")),
    "bomex_bulk": dict(
        jax=lambda: jax_bomex("bulk"), bisect=True, courant=0.35,
        box=((800.0, 800.0, 375.0), (6400.0, 6400.0, 3000.0)),
        port=lambda res, dom: bomex_les.bomex_config(
            res, dom, "bulk", device="cpu")),
    "dycoms": dict(
        jax=jax_dycoms, bisect=True, courant=0.3,
        box=((105.0, 105.0, 187.5), dycoms.DOMAIN),
        port=lambda res, dom: dycoms.dycoms_config(res, device="cpu")),
    "convective_bl": dict(
        jax=jax_convective_bl, bisect=False, courant=0.4,
        box=((600.0, 600.0, 400.0), (4800.0, 4800.0, 3200.0)),
        port=lambda res, dom: boundary_layer_les.convective_bl_config(
            res, dom, device="cpu")),
    "stable_bl_bulk": dict(
        jax=lambda: jax_stable_bl("bulk"), bisect=False, courant=0.4,
        box=((12.5, 12.5, 50.0), (100.0, 100.0, 400.0)),
        port=lambda res, dom: boundary_layer_les.stable_bl_config(
            res, dom, "bulk", device="cpu")),
    "stable_bl_custom_sbl": dict(
        jax=lambda: jax_stable_bl("custom_sbl"), bisect=False, courant=0.4,
        box=((12.5, 12.5, 50.0), (100.0, 100.0, 400.0)),
        port=lambda res, dom: boundary_layer_les.stable_bl_config(
            res, dom, "custom_sbl", device="cpu")),
    "canopy_dry": dict(
        jax=lambda: jax_canopy("dry"), bisect=False, courant=0.1,
        box=(CANOPY_RES, (100.0, 100.0, 100.0)), lsrk144=True,
        port=lambda res, dom: canopy_sgstke.canopy_config(
            res, dom, "dry", device="cpu")),
    "canopy_equilibrium": dict(
        jax=lambda: jax_canopy("equilibrium"), bisect=False, courant=0.1,
        box=(CANOPY_RES, (100.0, 100.0, 100.0)), lsrk144=True,
        port=lambda res, dom: canopy_sgstke.canopy_config(
            res, dom, "equilibrium", device="cpu")),
}


def _jax_tmar(model, grid):
    from climatemachine_tpu.mesh.filters import tmar
    from climatemachine_tpu.ode.callbacks import EveryXSimulationSteps
    slot = [model.prog_spec.flattened_names().index("moisture.rhoq_tot")]

    def apply_tmar(state):
        state.q = tmar(grid, state.q, fields=slot)

    return EveryXSimulationSteps(apply_tmar, 1)


def run_case(key):
    """Both packages' case ``key`` on its small box: the initial states,
    the JAX aux, the RHS of the JAX initial state in both, and the state
    and norm ratio after N_STEPS steps of ``invoke`` (BOMEX with TMAR
    every step) from the JAX initial state and dt."""
    case = CASES[key]
    res, dom = case["box"]
    jcm.init(show_updates="never")
    cm.init(show_updates="never")
    jmodel = case["jax"]()
    jdc = jcm.AtmosLESConfiguration(key, 4, res, *dom, jmodel,
                                    dtype=np.float64)
    kw = {}
    if case.get("lsrk144"):
        kw["ode_solver_type"] = jcm.ExplicitSolverType(
            solver_method=jcm.LSRK144NiegemannDiehlBusch)
    jsc = jcm.make_solver_configuration(0.0, -1.0, jdc,
                                        Courant_number=case["courant"], **kw)
    dt = float(jsc.dt)
    jsc.timeend = N_STEPS * dt
    dc = case["port"](res, dom)
    assert dc.grid.nelem == jdc.grid.nelem == 8
    pkw = ({"ode_solver_type": canopy_sgstke.SOLVER_TYPE}
           if case.get("lsrk144") else {})
    sc = cm.make_solver_configuration(0.0, N_STEPS * dt, dc, ode_dt=dt,
                                      **pkw)
    out = dict(jax_q0=np.asarray(jsc.q), jax_aux0=np.asarray(jsc.aux),
               port_q0=nm(sc.q), port_aux0=nm(sc.aux), dt=dt,
               port_dt=cm.calculate_dt(dc.grid, dc.model, vm(jsc.q),
                                       vm(jsc.aux), case["courant"]))
    # the JAX solver steps eagerly around one jitted RHS (a jitted
    # LSRK144 step with the saturation adjustment compiles for a minute)
    jdg = jsc.dg
    jrhs = jax.jit(lambda a, b, t: jdg(a, b, t))
    jsc.solver.rhs = lambda a, b, t: jrhs(a, b, float(t))
    jsc.solver.jits_itself = True
    # one RHS at the perturbed JAX initial state in both
    qp = perturbed(jsc.q, seed=0)
    out["port_rhs"] = nm(sc.dg(vm(qp), vm(jsc.aux), 0.0)[0])
    out["jax_rhs"] = np.asarray(jsc.solver.rhs(jnp.asarray(qp), jsc.aux,
                                               0.0)[0])
    # N_STEPS of invoke from the JAX initial state
    bomex = key.startswith("bomex")
    sc.q, sc.aux = vm(jsc.q), vm(jsc.aux)
    out["port_ratio"] = cm.invoke(
        sc, user_callbacks=[bomex_les.tmar_callback(dc)] if bomex else [])
    out["jax_ratio"] = jcm.invoke(
        jsc, user_callbacks=[_jax_tmar(jmodel, jdc.grid)] if bomex else [])
    out["port_q"], out["jax_q"] = nm(sc.q), np.asarray(jsc.q)
    return out


def runs_fixture(key):
    """A module fixture ``runs`` giving (key, :func:`run_case` (key))."""
    @pytest.fixture(scope="module", name="runs")
    def runs():
        return key, run_case(key)
    return runs


def test_dt_matches_jax(runs):
    _, out = runs
    assert abs(out["port_dt"] - out["dt"]) <= 1e-12 * out["dt"]


def test_initial_state_matches_jax(runs):
    key, out = runs
    tol = BISECT_INIT_TOL if CASES[key]["bisect"] else EXACT_INIT_TOL
    err = var_err(out["port_q0"], out["jax_q0"])
    assert np.all(err <= tol), (err, tol)
    assert np.all(np.isfinite(out["port_q0"]))


def test_aux_matches_jax(runs):
    key, out = runs
    err = lane_err(out["port_aux0"], out["jax_aux0"])
    tol = BISECT_INIT_TOL if CASES[key]["bisect"] else TOL
    assert np.all(err <= tol), err


def test_rhs_matches_jax(runs):
    _, out = runs
    err = rel_err_per_var(out["port_rhs"], out["jax_rhs"])
    assert np.all(err <= TOL), err


def test_invoke_matches_jax(runs):
    _, out = runs
    err = rel_err_per_var(out["port_q"], out["jax_q"])
    assert np.all(err <= TOL), err
    assert abs(out["port_ratio"] - out["jax_ratio"]) <= 1e-12
    assert np.all(np.isfinite(out["port_q"]))
