"""Shared set-up of test_torch_single_stack.py and
test_torch_cfsite_amip.py: a case built in both packages through the
driver entry (the JAX side as its example's ``main`` builds it, the
port's from ``climatemachine_tpu_torch.experiments``), in float64 (the
port on the CPU): the initial states, dt, one RHS at the JAX initial
state times 1 + 1e-3 · N(0, 1) from a numpy seed, and one step of
``invoke`` from the JAX initial state with TMAR on ρq_tot after it.  The
JAX ``invoke`` steps around one jitted RHS (a jitted step with the
saturation adjustment compiles for a minute)."""

import jax
import jax.numpy as jnp
import numpy as np

from climatemachine_tpu import driver_api as jcm
from climatemachine_tpu_torch import driver_api as cm
from climatemachine_tpu_torch.experiments import bomex_les
from forced_les_parity import _jax_tmar, lane_err, var_err
from les_parity import nm, perturbed, vm

TOL = 1e-10


def run(jdc, dc, courant, steps=1):
    """Both configurations from the JAX initial state: a dict of
    node-major arrays and dt."""
    jcm.init(show_updates="never")
    cm.init(show_updates="never")
    jsc = jcm.make_solver_configuration(0.0, -1.0, jdc,
                                        Courant_number=courant)
    dt = float(jsc.dt)
    jsc.timeend = steps * dt
    sc = cm.make_solver_configuration(0.0, steps * dt, dc, ode_dt=dt)
    out = dict(jax_q0=np.asarray(jsc.q), port_q0=nm(sc.q),
               jax_aux0=np.asarray(jsc.aux), port_aux0=nm(sc.aux), dt=dt,
               port_dt=cm.calculate_dt(dc.grid, dc.model, vm(jsc.q),
                                       vm(jsc.aux), courant))
    jdg = jsc.dg
    jrhs = jax.jit(lambda a, b, t: jdg(a, b, t))
    jsc.solver.rhs = lambda a, b, t: jrhs(a, b, float(t))
    jsc.solver.jits_itself = True
    qp = perturbed(jsc.q, seed=0)
    out["port_rhs"] = nm(sc.dg(vm(qp), vm(jsc.aux), 0.0)[0])
    out["jax_rhs"] = np.asarray(jsc.solver.rhs(jnp.asarray(qp), jsc.aux,
                                               0.0)[0])
    sc.q, sc.aux = vm(jsc.q), vm(jsc.aux)
    cm.invoke(sc, user_callbacks=[bomex_les.tmar_callback(dc)])
    jcm.invoke(jsc, user_callbacks=[_jax_tmar(jdc.model, jdc.grid)])
    out["port_q"], out["jax_q"] = nm(sc.q), np.asarray(jsc.q)
    return out


def check_init(out, tol):
    err = var_err(out["port_q0"], out["jax_q0"])
    assert np.all(err <= tol), err
    err = lane_err(out["port_aux0"], out["jax_aux0"])
    assert np.all(err <= tol), err
    assert abs(out["port_dt"] - out["dt"]) <= 1e-12 * out["dt"]


def check_rhs(out):
    err = var_err(out["port_rhs"], out["jax_rhs"])
    assert np.all(err <= TOL), err


def check_step(out):
    err = var_err(out["port_q"], out["jax_q"])
    assert np.all(err <= TOL), err
    q_tot = out["port_q"][..., 5] / out["port_q"][..., 0]
    assert q_tot.min() >= 0.0
