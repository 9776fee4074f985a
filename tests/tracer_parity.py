"""Shared set-up of the tracer, precipitation and moist-flux parity tests
(test_torch_tracers.py, test_torch_precipitation.py,
test_torch_moist_fluxes.py): the moist baroclinic wave with two passive
tracers, ``baroclinic_wave_config(n_horz=2, n_vert=2, poly_order=3,
tracers=NTracers((1.0, 2.0)))``, with a precipitation model and its
microphysics source added from the public parts of each package
(``replace(physics, precipitation=RainModel())``, sources ``(Gravity(),
Coriolis(), WarmRain1M())`` by default), in float64, the port's on the
JAX grid's arrays; and a seeded test state: the JAX initial state
perturbed by 1e-3, ρq_tot raised to supersaturation on a third of the
nodes, rain (and snow) 1e-4 ρ there, and ρχ = ρ·(1, z/H), H the domain
height, as tests/test_moisture.py:85-86 sets its tracers."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from climatemachine_tpu.atmos import precipitation as jax_precip
from climatemachine_tpu.atmos import sources as jax_sources
from climatemachine_tpu.atmos.model import AtmosModel as JaxAtmosModel
from climatemachine_tpu.atmos.tracers import NTracers as JaxNTracers
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init_ode_state
from climatemachine_tpu.experiments.baroclinic_wave import \
    baroclinic_wave_config as jax_baroclinic_wave_config
from climatemachine_tpu_torch.atmos import precipitation, sources
from climatemachine_tpu_torch.atmos.model import AtmosModel
from climatemachine_tpu_torch.atmos.tracers import NTracers
from climatemachine_tpu_torch.dg.spatial import DGModel
from climatemachine_tpu_torch.experiments.baroclinic_wave import \
    baroclinic_wave_config
from climatemachine_tpu_torch.interop import (grid_from_numpy, grid_to_numpy,
                                              state_from_numpy, to_var_major)

SIZE = dict(n_horz=2, n_vert=2, poly_order=3)
DELTA_CHI = (1.0, 2.0)
#: the domain height (baroclinic_wave_config's default)
H = 30e3
#: per variable, relative to the reference's largest magnitude: the
#: generic RHS's precedent (tests/test_torch_generic_dg.py, from
#: tests/test_fast_rhs.py:53)
RHS_TOL = 1e-11
#: (precipitation model, microphysics source), by the classes' names in
#: both packages
WARM_RAIN = ("RainModel", "WarmRain1M")


def models(precip=WARM_RAIN):
    """(JAX config, JAX model, port config, port model): the wave with
    the two tracers and, from ``precip`` = (precipitation model or None,
    source), that precipitation and ``(Gravity(), Coriolis(), source)``."""
    model_name, source_name = precip
    cfg_j = jax_baroclinic_wave_config(dtype=np.float64,
                                       tracers=JaxNTracers(DELTA_CHI), **SIZE)
    cfg_t = baroclinic_wave_config(dtype=torch.float64, device="cpu",
                                   tracers=NTracers(DELTA_CHI), **SIZE)
    out = []
    for cfg, prec_mod, src_mod, cls in (
            (cfg_j, jax_precip, jax_sources, JaxAtmosModel),
            (cfg_t, precipitation, sources, AtmosModel)):
        physics = cfg.model.physics
        if model_name is not None:
            physics = replace(physics,
                              precipitation=getattr(prec_mod, model_name)())
        out.append(cls(physics, cfg.model.problem, sources=(
            src_mod.Gravity(), src_mod.Coriolis(),
            getattr(prec_mod, source_name)())))
    return cfg_j, out[0], cfg_t, out[1]


def port_grid(cfg_j):
    return grid_from_numpy(grid_to_numpy(cfg_j.grid), device="cpu",
                           dtype=torch.float64)


def seeded_state(model_j, q0, aux0, seed: int = 17):
    """The seeded test state (module docstring), node-major numpy."""
    rng = np.random.default_rng(seed)
    sp = model_j.prog_spec
    q = np.asarray(q0) * (1 + 1e-3 * rng.standard_normal(np.shape(q0)))
    rho = q[..., 0]
    wet = rng.uniform(size=rho.shape) < 1 / 3
    iq = sp.index("moisture.rhoq_tot").start
    q[..., iq] = np.where(wet, 4.0 * q[..., iq] + 2e-3 * rho, q[..., iq])
    if "precipitation" in sp.names():
        sl = sp.index("precipitation")
        q[..., sl] = np.where(wet, 1e-4 * rho, 0.0)[..., None]
    z = np.asarray(model_j.aux_get(aux0, "orientation.Phi")) \
        / model_j.param_set.grav
    q[..., sp.index("tracers.rhochi")] = rho[..., None] * np.stack(
        [np.ones_like(z), z / H], axis=-1)
    return q


def setup(precip=WARM_RAIN, seed: int = 17):
    """Both models, the JAX DGModel (its defaults on the CPU: the
    var-major chain, the XLA volume contraction, the node-gather
    surface), its initial state, the test state, and the port's DGModel
    on the JAX grid's arrays."""
    cfg_j, model_j, cfg_t, model_t = models(precip)
    dg_j = JaxDGModel(model_j, cfg_j.grid)
    q0, aux0 = jax_init_ode_state(dg_j)
    q = seeded_state(model_j, q0, aux0, seed)
    return dict(cfg_j=cfg_j, model_j=model_j, dg_j=dg_j, q0=q0, aux0=aux0,
                q=q, cfg_t=cfg_t, model_t=model_t,
                dg_t=DGModel(model_t, port_grid(cfg_j)))


def port_state(s, q=None):
    """The port's var-major (q, aux0) of the test state (or ``q``), the
    lanes checked by name against the JAX model's schema."""
    mj = s["model_j"]
    return state_from_numpy(
        s["q"] if q is None else q, s["aux0"], device="cpu",
        model=s["model_t"], names=(mj.prog_spec.flattened_names(),
                                   mj.aux_spec.flattened_names()))


def jit_rhs(dg_j):
    """``dg_j``'s RHS, jitted: (q, aux, t) -> (dq, aux')."""
    return jax.jit(lambda q, aux, t: dg_j(q, aux, t))


def rel_err_per_var(got_vm, ref_node_major):
    """max |got − ref| per variable over max |ref| of that variable;
    ``got`` var-major (a tensor), ``ref`` node-major."""
    ref = to_var_major(np.asarray(ref_node_major), "cpu").numpy()
    got = got_vm.detach().cpu().numpy()
    scale = np.maximum(np.max(np.abs(ref), axis=(0, 2)), 1e-300)
    return np.max(np.abs(got - ref), axis=(0, 2)) / scale


def as_jax(a):
    return jnp.asarray(np.asarray(a))
