"""The port's hyperdiffusion LDG chain (climatemachine_tpu_torch.dg
.ldg_kernel and .ldg_varmajor) against the JAX package, in float64 on the
CPU:

- each of the four plain kernel versions against the JAX Pallas body run
  through ``pl.pallas_call(..., interpret=True)``, built with
  ``pallas_ldg._specs`` as ``pallas_ldg.chain_vm`` builds it, on random
  inputs at E=16, Np=64, F=64 with the 2x2 p3 grid's 0/1 face tables,
  1e-12 relative;
- the port's ``chain_vm`` against JAX ``pallas_ldg.chain_vm`` (interpret
  mode) on the 2x2 p3 Held-Suarez grid carried across with interop,
  1e-11 relative;
- the port's per-pass grad_vm → div_vm → grad_vm against the JAX
  package's, 1e-11, and the port's kernel chain against it.

On CPU tensors every chain wrapper is its plain version, bit for bit;
chip_smoke.py holds the CUDA kernels against the plain versions on the
card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from climatemachine_tpu.dg import ldg_varmajor as jax_lvm
from climatemachine_tpu.dg import pallas_ldg
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu_torch.dg import ldg_kernel, ldg_tables, ldg_varmajor
from climatemachine_tpu_torch.dg.spatial import (direction_dims,
                                                 direction_faces)
from climatemachine_tpu_torch.interop import grid_from_numpy, grid_to_numpy

E, N, ND, BE = 16, 4, 2, 8
DIMS = direction_dims("horizontal", 3)
FACES = direction_faces("horizontal", 3)


@pytest.fixture(scope="module")
def setup():
    """The JAX Held-Suarez (hyperdiffusion on) model on the 2x2 p3 grid,
    the port's chain operators on the same grid's arrays, and a seeded
    random chain input."""
    cfg = jax_held_suarez_config(2, 2, 3, dtype=np.float64)
    dg_j = JaxDGModel(cfg.model, cfg.grid)
    grid_t = grid_from_numpy(grid_to_numpy(cfg.grid), device="cpu",
                             dtype=torch.float64)
    ops = ldg_kernel.chain_operators(grid_t, DIMS, FACES)
    xv = np.random.default_rng(11).standard_normal(
        (grid_t.nelem, N, grid_t.Np))
    return dict(dg_j=dg_j, grid_t=grid_t, ops=ops, xv=xv)


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _vmem_block(shape):
    return pl.BlockSpec((BE,) + shape, lambda i, r=len(shape): (i,) + (0,) * r,
                        memory_space=pltpu.VMEM)


def _pallas(body, in_groups, outs, args):
    """``body`` through pl.pallas_call in interpret mode: ``in_groups`` is
    a list of (per-element shapes, static shapes) for ``_specs``, ``outs``
    the per-element output shapes."""
    in_specs = []
    for shapes, statics in in_groups:
        in_specs += pallas_ldg._specs(BE, shapes, statics)
    call = pl.pallas_call(
        body, grid=(E // BE,), in_specs=in_specs,
        out_specs=[_vmem_block(s) for s in outs],
        out_shape=[jax.ShapeDtypeStruct((E,) + s, jnp.float64)
                   for s in outs],
        interpret=True)
    return call(*(jnp.asarray(a) for a in args))


def _stage_case(stage, ops, rng):
    """(JAX body, in_groups, out shapes, JAX args, port wrapper, port
    args) for one chain stage on random inputs."""
    fo = ops.fo
    Np, F = fo.Sel.shape
    r = lambda *s: rng.standard_normal(s)
    xi, Wd = r(E, ND * 3, Np), r(ND, Np, Np)
    MI, w3, nrm, sM = r(E, Np), r(E, 3, F), r(E, 3, F), r(E, F)
    Sel, LT = fo.Sel.numpy(), fo.LT.numpy()
    kw = dict(nd=ND, F=F)
    if stage == "first":
        x = r(E, N, Np)
        return (functools.partial(pallas_ldg._k_first, **kw),
                [([(N, Np), (ND * 3, Np)], [(ND, Np, Np), (Np, F)])],
                [(3, N, Np), (N, F)], [x, xi, Wd, Sel],
                ldg_kernel.ldg_first, [x, xi, Wd])
    if stage == "grad_to_div":
        vol1, dj = r(E, 3, N, Np), r(E, N, F)
        return (functools.partial(pallas_ldg._k_grad_to_div, **kw),
                [([(3, N, Np), (N, F), (3, F), (3, F), (Np,)], [(F, Np)]),
                 ([(ND * 3, Np)], [(ND, Np, Np), (Np, F)])],
                [(N, Np), (N, F)], [vol1, dj, w3, nrm, MI, LT, xi, Wd, Sel],
                ldg_kernel.ldg_grad_to_div, [vol1, dj, w3, nrm, MI, xi, Wd])
    if stage == "div_to_grad":
        div, dj2 = r(E, N, Np), r(E, N, F)
        return (functools.partial(pallas_ldg._k_div_to_grad, **kw),
                [([(N, Np), (N, F), (F,), (Np,)], [(F, Np)]),
                 ([(ND * 3, Np)], [(ND, Np, Np), (Np, F)])],
                [(3, N, Np), (N, F)], [div, dj2, sM, MI, LT, xi, Wd, Sel],
                ldg_kernel.ldg_div_to_grad, [div, dj2, sM, MI, xi, Wd])
    vol3, dj3 = r(E, 3, N, Np), r(E, N, F)
    return (functools.partial(pallas_ldg._k_last, F=F),
            [([(3, N, Np), (N, F), (3, F), (Np,)], [(F, Np)])],
            [(3, N, Np)], [vol3, dj3, w3, MI, LT],
            ldg_kernel.ldg_last, [vol3, dj3, w3, MI])


STAGES = ["first", "grad_to_div", "div_to_grad", "last"]
PLAIN = dict(zip(STAGES, ldg_kernel.PLAIN))


@pytest.mark.parametrize("stage", STAGES)
def test_plain_stage_matches_jax_kernel(setup, stage):
    ops = setup["ops"]
    assert ops.fo.Sel.shape == (64, 64)
    body, groups, outs, jargs, wrapper, targs = _stage_case(
        stage, ops, np.random.default_rng(STAGES.index(stage)))
    ref = _pallas(body, groups, outs, jargs)
    targs = [torch.as_tensor(a) for a in targs] + [ops.fo]
    got = PLAIN[stage](*targs)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert _rel_err(g.numpy(), r) < 1e-12
    # on CPU tensors the wrapper is the plain version, bit for bit
    wrapped = wrapper(*targs)
    wrapped = wrapped if isinstance(wrapped, tuple) else (wrapped,)
    for w, g in zip(wrapped, got):
        np.testing.assert_array_equal(w.numpy(), g.numpy())


def test_face_ops_index_tables(setup):
    """The kernels' index tables are the dense 0/1 operators: Sel's
    columns gather sel_idx, LT scatters each face column to its node."""
    fo = setup["ops"].fo
    Np, F = fo.Sel.shape
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((3, Np)))
    np.testing.assert_array_equal((x @ fo.Sel).numpy(),
                                  x[:, fo.sel_idx.long()].numpy())
    y = torch.as_tensor(np.random.default_rng(6).standard_normal((3, F)))
    lifted = torch.zeros((3, Np), dtype=y.dtype)
    for m in range(Np):
        for f in fo.lift_idx[m].tolist():
            if f >= 0:
                lifted[:, m] += y[:, f]
    np.testing.assert_allclose((y @ fo.LT).numpy(), lifted.numpy(),
                               rtol=1e-15, atol=0)
    with pytest.raises(ValueError):
        ldg_tables.face_ops(2 * fo.Sel, fo.LT)


def test_chain_matches_jax_pallas_chain(setup):
    ref = pallas_ldg.chain_vm(setup["dg_j"], jnp.asarray(setup["xv"]), DIMS,
                              FACES, interpret=True, block_e=16)
    got = ldg_kernel.chain_vm(torch.as_tensor(setup["xv"]), setup["ops"])
    assert _rel_err(got.numpy(), ref) < 1e-11


def _per_pass_chain(setup):
    g = setup["grid_t"]
    tab = ldg_tables.tables(g, FACES)
    geom = ldg_tables.geom(g, FACES, DIMS)
    x = torch.as_tensor(setup["xv"])
    grad = ldg_varmajor.grad_vm(g, x, tab, geom, DIMS)
    lap = ldg_varmajor.div_vm(g, grad, tab, geom, DIMS)
    return ldg_varmajor.grad_vm(g, lap, tab, geom, DIMS)


def test_per_pass_chain_matches_jax(setup):
    dg = setup["dg_j"]
    tab = jax_lvm._tables(dg, FACES, N)
    geom = jax_lvm._geom(dg, FACES, DIMS)
    x = jnp.asarray(setup["xv"])
    grad = jax_lvm.grad_vm(dg, x, tab, geom, DIMS)
    lap = jax_lvm.div_vm(dg, grad, tab, geom, DIMS)
    ref = jax_lvm.grad_vm(dg, lap, tab, geom, DIMS)
    assert _rel_err(_per_pass_chain(setup).numpy(), ref) < 1e-11


def test_kernel_chain_matches_per_pass_chain(setup):
    got = ldg_kernel.chain_vm(torch.as_tensor(setup["xv"]), setup["ops"],
                              ldg_kernel.PLAIN)
    assert _rel_err(got.numpy(), _per_pass_chain(setup).numpy()) < 1e-11
