"""Shared set-up of the EDMF parity tests (test_torch_edmf*.py): the
stable-boundary-layer single stack of tests/test_edmf.py (``_sbl_setup``,
the JAX package's) and of the port's experiments/bomex_edmf.py, at
``NZ`` elements to 400 m, p4, float64 (the port on the CPU), for the
decoupled, the coupled and the moist (two updrafts, EquilMoist) case.

What the tests hold, both packages from the JAX package's states:
- the lane names of the state, aux, gradient and gradient flux;
- the initial state and its aux (the subdomain temperatures among them);
- at the "seeded" state, the JAX initial state with updrafts of 1-3 %
  area, rising at 0.1-0.5 m/s, at θ_liq 265.1-265.3 K (and, moist, 2-6 %
  moister than the grid mean), the whole state then times 1 + 1e-3 ·
  N(0, 1) from a numpy seed (at the initial state every updraft is void,
  a_min = 0, so their branches would go unchecked): the aux refresh, the
  gradient flux and one RHS;
- ``N_STEPS`` LSRK144 steps with TMAR on the EDMF lanes (all but ρaw)
  from the JAX initial state.

Each comparison is per lane: max|port − JAX| over the lane's largest JAX
value; the momentum lanes (ρu's and the updrafts' ρaw) share the
largest of theirs, and a lane whose JAX values are all 0 (∇Φ's
horizontal lanes) is scaled by 1.

The JAX functions are jitted (its init with the saturation adjustment
costs seconds eagerly), the JAX solver steps eagerly around one jitted
RHS (a jitted LSRK144 step of the EDMF RHS compiles for minutes), which
XLA compiles while the port takes its steps (the moist RHS compiles for
about 9 s, the port's steps take 4: one file each would not fit in 25
s).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_edmf
from climatemachine_tpu.atmos.edmf import (EDMF, Coupled,
                                           NeutralDrySurfaceModel,
                                           SurfaceModel)
from climatemachine_tpu.mesh.filters import tmar as jax_tmar
from climatemachine_tpu.mesh.grid import min_node_distance
from climatemachine_tpu.ode.lsrk import LSRK144NiegemannDiehlBusch
from climatemachine_tpu_torch.experiments import bomex_edmf
from les_parity import nm, perturbed, vm

NZ = 5
N_STEPS = 3
TOL_INIT = 1e-12
TOL_RHS = 1e-11
TOL_STEPS = 1e-10
#: the steps' tolerance on the θ_liq variance lane: the JAX package does
#: not reproduce it to 1e-10 itself (its own 3 steps move by 9.6e-11
#: decoupled and 1.2e-10 coupled when its RHS is compiled at XLA's
#: backend optimization level 0 in place of the default; no branch
#: flips): the variance is a small second moment (1e-5 K²·kg/m³) built
#: from differences of θ ≈ 265 K
TOL_STEPS_LANES = {"turbconv.en_rhoatheta_liq_cv": 5e-10}
#: the JAX package's EDMF of each case (the port's is bomex_edmf.CASES)
JAX_EDMF = {
    "decoupled": lambda: EDMF(N_up=1, surface=NeutralDrySurfaceModel()),
    "coupled": lambda: EDMF(N_up=1, surface=NeutralDrySurfaceModel(),
                            coupling=Coupled()),
    "moist": lambda: EDMF(N_up=2, surface=SurfaceModel(
        obukhov_length=-100.0)),
}


def lane_err(got, ref, names=None):
    """max|got − ref| per lane (last axis of node-major arrays) over the
    lane's scale: max|ref| of it, shared by the momentum lanes where
    ``names`` are given, 1 where the lane is 0 throughout."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    axes = tuple(range(ref.ndim - 1))
    scale = np.max(np.abs(ref), axis=axes)
    if names is not None:
        mom = [i for i, n in enumerate(names)
               if n.startswith(("rhou[", "turbconv.up_rhoaw"))]
        scale[mom] = scale[mom].max()
    return np.max(np.abs(got - ref), axis=axes) / np.where(scale > 0, scale,
                                                           1.0)


def worst(err, names):
    """(largest error, its lane's name)."""
    i = int(np.argmax(err))
    return float(err[i]), names[i]


def jax_stack(case, init=True):
    """(model, dg, grid, q0, aux0) of the JAX package's ``case``, its
    ``init_ode_state`` jitted (q0 and aux0 None without ``init``)."""
    jax_init = test_edmf.init_ode_state
    test_edmf.init_ode_state = (
        (lambda dg: jax.jit(lambda: jax_init(dg))()) if init
        else (lambda dg: (None, None)))
    try:
        return test_edmf._sbl_setup(JAX_EDMF[case](), nz=NZ,
                                    moist=case == "moist")
    finally:
        test_edmf.init_ode_state = jax_init


def seeded(q, names, seed=0):
    """The seeded state of the module docstring (node-major numpy)."""
    q = np.array(q)
    rng = np.random.default_rng(seed + 100)
    lane = {n: i for i, n in enumerate(names)}
    rho = q[..., lane["rho"]]
    for n, i in lane.items():
        if not n.startswith("turbconv.up_rhoa") or "rhoaw" in n \
                or "rhoatheta" in n or "rhoaq" in n:
            continue
        k = n[len("turbconv.up_rhoa"):]                 # "" or "[j]"
        a = rng.uniform(0.01, 0.03, rho.shape)
        q[..., i] = rho * a
        q[..., lane["turbconv.up_rhoaw" + k]] = \
            rho * a * rng.uniform(0.1, 0.5, rho.shape)
        q[..., lane["turbconv.up_rhoatheta_liq" + k]] = \
            q[..., lane["turbconv.up_rhoatheta_liq" + k]] \
            + rho * a * (265.0 + rng.uniform(0.1, 0.3, rho.shape))
        if "moisture.rhoq_tot" in lane:
            q[..., lane["turbconv.up_rhoaq_tot" + k]] = \
                a * q[..., lane["moisture.rhoq_tot"]] \
                * rng.uniform(1.02, 1.06, rho.shape)
    return perturbed(q, seed=seed)


def aux_and_gradient_flux(jmodel, jdg):
    """The JAX package's aux refresh and gradient flux at (q, aux),
    jitted as one function."""
    def f(q, aux):
        aux = jmodel.nodal_update_auxiliary_state(q, aux, 0.0)
        return aux, jmodel.compute_gradient_flux(
            jdg.spatial_gradient(q, aux, 0.0), q, aux, 0.0)
    return jax.jit(f)


def port_aux_and_gradient_flux(model, dg, q, aux):
    aux = model.update_auxiliary_state(q, aux, dg.grid)
    return aux, model.compute_gradient_flux(dg.spatial_gradient(q, aux, 0.0),
                                            q, aux, 0.0)


def compile_rhs(jdg, q, aux):
    """The JAX package's RHS lowered now and compiled in a thread (XLA's
    compilation releases the interpreter, so the port's steps run
    meanwhile); returns the thread and the box that gets "rhs"."""
    lowered = jax.jit(lambda a, b, t: jdg(a, b, t)).lower(q, aux, 0.0)
    box = {}

    def build():
        # XLA's backend optimization level 0: a third less compile time
        box["rhs"] = lowered.compile(
            compiler_options={"xla_backend_optimization_level": 0})

    thread = threading.Thread(target=build)
    thread.start()
    return thread, box


def port_steps(case, q0, aux0):
    """``N_STEPS`` LSRK144 steps with TMAR of the port's ``case`` from
    (q0, aux0) (node-major): (q, dt)."""
    model, dg, grid, _, _ = bomex_edmf.sbl_stack(case, NZ, device="cpu")
    step, dt = bomex_edmf.stepper(model, dg, grid)
    q, x, t = vm(q0), vm(aux0), 0.0
    # one thread: these tensors are small, and XLA compiles meanwhile
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for _ in range(N_STEPS):
            q, x = step(q, x, t)
            t += dt
    finally:
        torch.set_num_threads(threads)
    return nm(q), dt


def jax_steps(jmodel, jgrid, jrhs, jq0, jaux0):
    """The same with the JAX package's LSRK144 around its RHS ``jrhs``:
    (q, dt)."""
    dt = 0.4 * float(min_node_distance(jgrid)) / 340.0
    jsolver = LSRK144NiegemannDiehlBusch(jrhs, dt)
    slots = [i for i, n in enumerate(jmodel.prog_spec.flattened_names())
             if n.startswith("turbconv.") and "rhoaw" not in n]
    jq, jx, t = jq0, jaux0, 0.0
    for _ in range(N_STEPS):
        jq, jx = jsolver.step(jq, jx, t)
        jq = jax_tmar(jgrid, jq, fields=slots)
        t += dt
    return np.asarray(jq), dt


def run_case(case, parts=("init", "aux_gf", "rhs", "steps")):
    """Both packages' ``case``: a dict of node-major numpy arrays
    (``port_*``, ``jax_*``) for each of ``parts``, and the lane names.
    Without "init" the JAX package's initial state is taken to be the
    port's (its own costs seconds of compilation)."""
    model, dg, grid, q0, aux0 = bomex_edmf.sbl_stack(case, NZ,
                                                     device="cpu")
    jmodel, jdg, jgrid, jq0, jaux0 = jax_stack(case, "init" in parts)
    if jq0 is None:
        jq0, jaux0 = jnp.asarray(nm(q0)), jnp.asarray(nm(aux0))
    names = model.prog_spec.flattened_names()
    out = dict(names=names, aux_names=model.aux_spec.flattened_names(),
               gf_names=model.gf_spec.flattened_names())
    if "init" in parts:
        out.update(port_q0=nm(q0), jax_q0=np.asarray(jq0),
                   port_aux0=nm(aux0), jax_aux0=np.asarray(jaux0))
    qs = jnp.asarray(seeded(jq0, names))
    if "aux_gf" in parts:
        ja, jg = aux_and_gradient_flux(jmodel, jdg)(qs, jaux0)
        pa, pg = port_aux_and_gradient_flux(model, dg, vm(qs), vm(jaux0))
        out.update(jax_aux=np.asarray(ja), jax_gf=np.asarray(jg),
                   port_aux=nm(pa), port_gf=nm(pg))
    if "rhs" not in parts and "steps" not in parts:
        return out
    thread, box = compile_rhs(jdg, jq0, jaux0)
    if "rhs" in parts:
        out["port_rhs"] = nm(dg(vm(qs), vm(jaux0), 0.0)[0])
    if "steps" in parts:
        out["port_q"], out["port_dt"] = port_steps(case, jq0, jaux0)
    thread.join()
    jrhs = lambda a, b, t: box["rhs"](a, b, t)
    if "rhs" in parts:
        out["jax_rhs"] = np.asarray(jrhs(qs, jaux0, 0.0)[0])
    if "steps" in parts:
        out["jax_q"], out["dt"] = jax_steps(jmodel, jgrid, jrhs, jq0, jaux0)
    return out


# --- the tests each case's file runs -------------------------------------------

def check_init(out):
    err = lane_err(out["port_q0"], out["jax_q0"], out["names"])
    assert err.max() <= TOL_INIT, worst(err, out["names"])
    err = lane_err(out["port_aux0"], out["jax_aux0"])
    assert err.max() <= TOL_INIT, worst(err, out["aux_names"])


def check_aux_gf(out):
    err = lane_err(out["port_aux"], out["jax_aux"])
    assert err.max() <= TOL_INIT, worst(err, out["aux_names"])
    err = lane_err(out["port_gf"], out["jax_gf"])
    assert err.max() <= TOL_RHS, worst(err, out["gf_names"])


def check_rhs(out):
    err = lane_err(out["port_rhs"], out["jax_rhs"], out["names"])
    assert err.max() <= TOL_RHS, worst(err, out["names"])
    assert np.all(np.isfinite(out["port_rhs"]))


def check_steps(out):
    assert abs(out["port_dt"] - out["dt"]) <= 1e-15 * out["dt"]
    err = lane_err(out["port_q"], out["jax_q"], out["names"])
    tol = np.array([TOL_STEPS_LANES.get(n, TOL_STEPS) for n in out["names"]])
    assert np.all(err <= tol), worst(err / tol * TOL_STEPS, out["names"])
    up = [i for i, n in enumerate(out["names"])
          if n.startswith("turbconv.up_rhoa") and "rhoaw" not in n
          and "rhoat" not in n and "rhoaq" not in n]
    # the surface injected updraft area, which TMAR keeps positive
    assert out["port_q"][..., up].max() > 0
    assert out["port_q"][..., up].min() >= 0
