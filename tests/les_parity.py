"""Shared set-up of the LES parity tests (test_torch_turbulence.py,
test_torch_gradient_dg.py, test_torch_les_driver.py): the dry rising
bubble of tests/test_driver.py in both packages, with any turbulence
closure, moisture model, tracers, boundary conditions and sponge, on the
LES box of a stacked brick (lateral sides periodic, bottom wall tag 1,
top tag 2), and the conversions between their layouts.

The bubble: a hydrostatic dry-adiabatic reference state (300 K, 110 K
floor) with a 2 K warm bubble of radius ``BUBBLE[2]`` at ``BUBBLE[:2]``
(x, z); with EquilMoist a total water of ``Q_TOT`` (below saturation
near the ground, saturated aloft), with tracers ρχ = ρ·(1, z/L).
"""

import jax.numpy as jnp
import numpy as np
import torch

from climatemachine_tpu import driver_api as jcm
from climatemachine_tpu_torch import driver_api as cm
from climatemachine_tpu_torch.interop import to_node_major, to_var_major

L = 1000.0
BUBBLE = (500.0, 300.0, 200.0)
Q_TOT = 0.008


def _bubble_T(ps, x, z, p, clip, sqrt):
    xc, zc, rc = BUBBLE
    r = sqrt((x - xc) ** 2 + (z - zc) ** 2)
    return (300.0 + 2.0 * clip(1 - r / rc, 0.0, 1.0)) * (
        p / ps.MSLP) ** ps.kappa_d


def jax_model(turbulence=None, moisture=None, tracers=None, bcs=None,
              sponge=None, hyperdiffusion=None):
    """The JAX package's bubble model."""
    ps = jcm.EARTH
    physics = jcm.AtmosPhysics(
        ref_state=jcm.HydrostaticState(jcm.DryAdiabaticProfile(300.0,
                                                               110.0)),
        turbulence=turbulence, moisture=moisture, tracers=tracers,
        viscoussponge=sponge, hyperdiffusion=hyperdiffusion)

    def init(m, coords, aux, t):
        x, z = coords[..., 0], coords[..., 2]
        p = m.aux_spec.get(aux, "ref_state.p")
        Phi = m.aux_spec.get(aux, "orientation.Phi")
        T = _bubble_T(ps, x, z, p, jnp.clip, jnp.sqrt)
        pp = (jcm.td.PhasePartition.vapor(Q_TOT * jnp.ones_like(T))
              if moisture is not None else None)
        rho = p / (jcm.td.gas_constant_air(ps, pp) * T)
        vals = dict(rho=rho, rhoe=rho * (jcm.td.internal_energy(ps, T, pp)
                                         + Phi))
        if moisture is not None:
            vals["moisture.rhoq_tot"] = rho * Q_TOT
        if tracers is not None:
            vals["tracers.rhochi"] = jnp.stack([rho, rho * z / L], axis=-1)
        return m.prog_spec.pack(vals, batch_shape=rho.shape)

    return jcm.AtmosModel(
        physics, jcm.AtmosProblem(init_state=init, boundary_conditions=bcs
                                  or (jcm.AtmosBC(), jcm.AtmosBC())),
        sources=(jcm.Gravity(),))


def port_model(turbulence=None, moisture=None, tracers=None, bcs=None,
               sponge=None, hyperdiffusion=None):
    """The port's bubble model, the same as :func:`jax_model`'s."""
    ps = cm.EARTH
    physics = cm.AtmosPhysics(
        ref_state=cm.HydrostaticState(cm.DryAdiabaticProfile(300.0, 110.0)),
        turbulence=turbulence, moisture=moisture or cm.DryModel(),
        tracers=tracers, viscoussponge=sponge,
        hyperdiffusion=hyperdiffusion)

    def init(m, coords, aux, t):
        x, z = coords[:, 0], coords[:, 2]
        p = m.aux_spec.get(aux, "ref_state.p")
        Phi = m.aux_spec.get(aux, "orientation.Phi")
        T = _bubble_T(ps, x, z, p, torch.clamp, torch.sqrt)
        pp = (cm.td.PhasePartition.vapor(Q_TOT * torch.ones_like(T))
              if moisture is not None else None)
        rho = p / (cm.td.gas_constant_air(ps, pp) * T)
        vals = dict(rho=rho, rhoe=rho * (cm.td.internal_energy(ps, T, pp)
                                         + Phi))
        if moisture is not None:
            vals["moisture.rhoq_tot"] = rho * Q_TOT
        if tracers is not None:
            vals["tracers.rhochi"] = torch.stack([rho, rho * z / L], dim=1)
        return m.prog_spec.pack(vals)

    return cm.AtmosModel(
        physics, cm.AtmosProblem(init_state=init, boundary_conditions=bcs
                                 or (cm.AtmosBC(), cm.AtmosBC())),
        sources=(cm.Gravity(),))


def box_ranges(n=3, length=L):
    return [np.linspace(0.0, length, n + 1)] * 3


BOUNDARY = np.array(((0, 0), (0, 0), (1, 2)))


def grids(n=3, poly=3):
    """Both packages' grids of the n × n × n LES box at ``poly``, float64
    (the port's on the CPU)."""
    r = box_ranges(n)
    per = (True, True, False)
    return (jcm.make_grid(jcm.topology.stacked_brick_topology(r, per,
                                                              BOUNDARY),
                          poly, dtype=np.float64),
            cm.make_grid(cm.topology.stacked_brick_topology(r, per, BOUNDARY),
                         poly, dtype=torch.float64, device="cpu"))


def vm(a):
    """A node-major JAX array ``[E, Np, ...]`` as a var-major CPU tensor
    ``[E, ..., Np]``."""
    a = np.asarray(a)
    if a.ndim == 3:
        return to_var_major(a, device="cpu")
    return torch.tensor(np.moveaxis(a, 1, -1).copy())


def nm(t):
    """A var-major tensor ``[E, ..., Np]`` as a node-major numpy array."""
    if t.dim() == 3:
        return to_node_major(t)
    return np.moveaxis(t.detach().numpy(), -1, 1)


def perturbed(q, seed=0, eps=1e-3):
    """q times 1 + eps·N(0, 1) from a numpy seed (node-major numpy)."""
    q = np.asarray(q)
    return q * (1 + eps * np.random.default_rng(seed).standard_normal(
        q.shape))


def rel_err_per_var(got, ref, momentum=slice(1, 4)):
    """max|got − ref| per variable (last axis of node-major arrays) over
    max|ref| of it, the momentum's components over the largest."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    axes = tuple(range(ref.ndim - 1))
    scale = np.max(np.abs(ref), axis=axes)
    scale[momentum] = scale[momentum].max()
    return np.max(np.abs(got - ref), axis=axes) / scale
