"""The solid-body rotation through the GCM driver entry
(``experiments/solid_body_rotation.py``) against the JAX package's
example (examples/solid_body_rotation.py, whose model and configuration
are built here as its ``main`` builds them), in float64 on the CPU at
n_horz 2, n_vert 2, p3:

- the same dt, and one IMEX step through ``invoke`` (Roe flux, ARK2
  with the column solve, Courant 0.2 horizontal) from the example's
  rest state with a 10 m/s solid-body zonal wind added (so that the
  flux, Coriolis and the advection act), within 1e-10 relative per
  variable: ρ and ρe against their largest value; the momentum lanes
  against the larger of their largest value and ρ g Δt, the size of
  the pressure-gradient and gravity terms that cancel in the rest state
  (the packages differ there by round-off, well below 1e-10 of ρ g Δt,
  with and without the wind);
- the rest state at 300 s and 1800 s, as the example checks it: max |u|
  below its 0.5 m/s (``MAX_ABS_U``), the state finite and the mass kept
  within 1e-14 relative.

Only one step is compared: the rest state is unstable to round-off on
this grid (its spurious speed grows by orders of magnitude a step in
either package; the JAX example turns NaN before 7200 s,
ROADMAP reference caveats), so the packages' round-off difference grows
with it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu import driver_api as jcm
from climatemachine_tpu_torch.driver import driver
from climatemachine_tpu_torch.experiments import solid_body_rotation as sbr
from climatemachine_tpu_torch.interop import to_node_major, to_var_major
from climatemachine_tpu_torch.physics.parameters import EARTH

SIZE = dict(n_horz=2, n_vert=2, poly_order=3)
TOL = 1e-10
#: one IMEX step: the configuration's dt for this end time is the end time
STEP_T = 450.0


def jax_config(timeend):
    """The JAX example's solver configuration (its ``main`` up to
    ``invoke``) at SIZE in float64."""
    physics = jcm.AtmosPhysics(
        param_set=jcm.EARTH, orientation=jcm.SphericalOrientation(),
        ref_state=jcm.HydrostaticState(
            jcm.DecayingTemperatureProfile(290.0, 220.0, 8e3)))

    def init(m, coords, aux, t):
        s = m.aux_spec
        rho = s.get(aux, "ref_state.rho")
        rhoe = s.get(aux, "ref_state.rhoe")
        return m.prog_spec.pack({"rho": rho, "rhoe": rhoe},
                                batch_shape=rho.shape)

    model = jcm.AtmosModel(
        physics,
        jcm.AtmosProblem(init_state=init,
                         boundary_conditions=(jcm.AtmosBC(), jcm.AtmosBC())),
        sources=(jcm.Gravity(), jcm.Coriolis()))
    dc = jcm.AtmosGCMConfiguration(
        "solid_body_rotation", SIZE["poly_order"],
        (SIZE["n_horz"], SIZE["n_vert"]), 30e3, model, dtype=np.float64)
    dc.numerical_flux_first_order = jcm.RoeNumericalFlux()
    return jcm.make_solver_configuration(
        0.0, timeend, dc, ode_solver_type=jcm.IMEXSolverType(),
        Courant_number=0.2, CFL_direction="horizontal")


def port_config(timeend):
    driver.init(show_updates="never")
    return sbr.solid_body_rotation_config(timeend=timeend,
                                          dtype=torch.float64, device="cpu",
                                          **SIZE)


def with_wind(sc, speed):
    """The configuration's initial state with a zonal wind of ``speed``
    m/s at the equator (ρu = ρ Ω̂ × x / R · speed), node-major."""
    q = to_node_major(sc.q).copy()
    x = sc.dg.grid.coords.numpy()
    r = np.linalg.norm(x, axis=-1, keepdims=True)
    u = speed * np.stack([-x[..., 1], x[..., 0], np.zeros_like(x[..., 0])],
                         axis=-1) / r
    q[..., 1:4] = q[..., :1] * u
    return q


def test_imex_step_against_jax_example():
    jcm.init(show_updates="never")
    sc, jsc = port_config(STEP_T), jax_config(STEP_T)
    assert sc.dt == jsc.dt == STEP_T
    q0 = with_wind(sc, 10.0)
    sc.q, jsc.q = to_var_major(q0, device="cpu"), jnp.asarray(q0)
    driver.invoke(sc)
    jcm.invoke(jsc)
    got, ref = to_node_major(sc.q), np.asarray(jsc.q)
    scale = np.abs(ref).max(axis=(0, 1))
    scale[1:4] = np.maximum(scale[1:4],
                            scale[0] * EARTH.grav * STEP_T)
    err = np.abs(got - ref).max(axis=(0, 1)) / scale
    assert err.max() < TOL, err
    assert bool(torch.isfinite(sc.q).all())


@pytest.mark.parametrize("timeend", [300.0, 1800.0])
def test_rest_state_kept(timeend):
    """The example's check: max |u| < 0.5 m/s, the state finite, the
    mass kept."""
    sc = port_config(timeend)
    q0 = sc.q
    driver.invoke(sc)
    s = sbr.rest_summary(sc, q0, sc.q)
    assert s["finite"] and s["max_abs_u"] < sbr.MAX_ABS_U, s
    assert s["mass_drift_rel"] < 1e-14, s
