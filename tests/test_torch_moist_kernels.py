"""The plain versions of the port's kernels at their moist branches
against the JAX Pallas kernels run in interpret mode, in float64 on the
CPU, and the CUDA wrappers' refusals of what is still not covered:

- the four chain stages at n = 5 rows (u_h, h_tot, q_tot) on seeded
  random inputs with the 2x2 p3 grid's face tables, each against its
  Pallas body, 1e-12 relative; the whole chain on the moist baroclinic
  wave's chain input against JAX ``pallas_ldg.chain_vm``, 1e-11;
- the volume tendency (nq = 6, with F₂ of ngl = 5 and without) and the
  surface extraction and flux + lift (nq = 6, hyperdiffusion on and
  off) on the inputs the moist var-major RHS hands them at a perturbed
  state of the baroclinic wave (n_horz=2, n_vert=2, p3), against
  ``fused_volume_tendency_vm``, ``extract_trace_vm`` and
  ``fused_surface_lift_vm``: 1e-12 of each output variable's or lane's
  largest magnitude;
- on CPU tensors each wrapper is its plain version, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from climatemachine_tpu.dg import pallas_ldg
from climatemachine_tpu.dg.pallas_surface import \
    extract_trace_vm as jax_extract_trace_vm
from climatemachine_tpu.dg.pallas_surface import \
    fused_surface_lift_vm as jax_fused_surface_lift_vm
from climatemachine_tpu.dg.pallas_volume import \
    fused_volume_tendency_vm as jax_fused_volume_tendency_vm
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.experiments.baroclinic_wave import \
    baroclinic_wave_config as jax_baroclinic_wave_config
from climatemachine_tpu_torch.dg import (ldg_kernel, surface_kernel,
                                        volume_kernel)
from climatemachine_tpu_torch.dg.fast_rhs import VarMajorRHS
from climatemachine_tpu_torch.dg.ldg_tables import FaceOps
from climatemachine_tpu_torch.dg.spatial import (DGModel, direction_dims,
                                                 direction_faces,
                                                 init_ode_state)
from climatemachine_tpu_torch.experiments.baroclinic_wave import \
    baroclinic_wave_config
from climatemachine_tpu_torch.interop import grid_from_numpy, grid_to_numpy

SIZE = dict(n_horz=2, n_vert=2, poly_order=3)
BLOCK_E = 16                       # divides the 48 elements of SIZE
E_RAND, N, ND = 16, 5, 2           # the random chain-stage inputs
DIMS = direction_dims("horizontal", 3)
FACES = direction_faces("horizontal", 3)
TOL = 1e-12


def _rel_err_per_lane(got, ref):
    """max |got − ref| per lane (axis 1) relative to max |ref| of it."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.maximum(np.max(np.abs(ref), axis=(0, 2)), 1e-300)
    return np.max(np.abs(got - ref), axis=(0, 2)) / scale


@pytest.fixture(scope="module")
def setup():
    """The moist baroclinic wave of both packages on the JAX grid's
    arrays, the port's moist var-major RHS, and a state of it: the
    initial state perturbed by 1e-3 (numpy, seed 13) with ρq_tot raised
    to supersaturation on a third of the nodes, so that the saturation
    adjustment condenses liquid and ice."""
    cfg_j = jax_baroclinic_wave_config(dtype=np.float64, **SIZE)
    cfg_t = baroclinic_wave_config(dtype=torch.float64, device="cpu", **SIZE)
    grid_t = grid_from_numpy(grid_to_numpy(cfg_j.grid), device="cpu",
                             dtype=torch.float64)
    dg_t = DGModel(cfg_t.model, grid_t)
    q0, aux0 = init_ode_state(dg_t)
    rng = np.random.default_rng(13)
    q = q0.numpy() * (1 + 1e-3 * rng.standard_normal(q0.shape))
    wet = rng.uniform(size=q[:, 5].shape) < 1 / 3
    q[:, 5] = np.where(wet, 4.0 * q[:, 5] + 2e-3 * q[:, 0], q[:, 5])
    q = torch.as_tensor(q)
    rhs = VarMajorRHS(dg_t)
    _, p, c_s, aux = rhs._thermo_update(q, aux0, True)
    glv = rhs.chain_input(q, aux, p)
    gl2 = ldg_kernel.chain_vm(glv, rhs.chain, ldg_kernel.PLAIN)
    return dict(dg_j=JaxDGModel(cfg_j.model, cfg_j.grid), rhs=rhs, q=q,
                aux=aux, p=p, c_s=c_s, glv=glv,
                gl2=gl2.reshape(q.shape[0], -1, q.shape[2]))


def test_state_condenses(setup):
    """The test state reaches both condensed phases."""
    sp = setup["rhs"].bl.aux_spec
    assert (sp.get(setup["aux"], "moisture.q_liq") > 0).sum() > 100
    assert (sp.get(setup["aux"], "moisture.q_ice") > 0).sum() > 100


# --- the chain at n = 5 ----------------------------------------------------------

def _pallas(body, in_groups, outs, args):
    """``body`` through pl.pallas_call in interpret mode, its specs built
    with ``pallas_ldg._specs`` as ``pallas_ldg.chain_vm`` builds them."""
    in_specs = []
    for shapes, statics in in_groups:
        in_specs += pallas_ldg._specs(8, shapes, statics)
    call = pl.pallas_call(
        body, grid=(E_RAND // 8,), in_specs=in_specs,
        out_specs=[pl.BlockSpec((8,) + s,
                                lambda i, r=len(s): (i,) + (0,) * r,
                                memory_space=pltpu.VMEM) for s in outs],
        out_shape=[jax.ShapeDtypeStruct((E_RAND,) + s, jnp.float64)
                   for s in outs],
        interpret=True)
    return call(*(jnp.asarray(a) for a in args))


def _stage_case(stage, fo, rng):
    """(JAX body, in_groups, out shapes, JAX args, port args) of one
    chain stage with N rows on random inputs."""
    Np, F = fo.Sel.shape
    r = lambda *s: rng.standard_normal(s)
    xi, Wd = r(E_RAND, ND * 3, Np), r(ND, Np, Np)
    MI, w3, nrm, sM = r(E_RAND, Np), r(E_RAND, 3, F), r(E_RAND, 3, F), \
        r(E_RAND, F)
    Sel, LT = fo.Sel.numpy(), fo.LT.numpy()
    kw = dict(nd=ND, F=F)
    if stage == "first":
        x = r(E_RAND, N, Np)
        return (functools.partial(pallas_ldg._k_first, **kw),
                [([(N, Np), (ND * 3, Np)], [(ND, Np, Np), (Np, F)])],
                [(3, N, Np), (N, F)], [x, xi, Wd, Sel], [x, xi, Wd])
    if stage == "grad_to_div":
        vol1, dj = r(E_RAND, 3, N, Np), r(E_RAND, N, F)
        return (functools.partial(pallas_ldg._k_grad_to_div, **kw),
                [([(3, N, Np), (N, F), (3, F), (3, F), (Np,)], [(F, Np)]),
                 ([(ND * 3, Np)], [(ND, Np, Np), (Np, F)])],
                [(N, Np), (N, F)], [vol1, dj, w3, nrm, MI, LT, xi, Wd, Sel],
                [vol1, dj, w3, nrm, MI, xi, Wd])
    if stage == "div_to_grad":
        div, dj2 = r(E_RAND, N, Np), r(E_RAND, N, F)
        return (functools.partial(pallas_ldg._k_div_to_grad, **kw),
                [([(N, Np), (N, F), (F,), (Np,)], [(F, Np)]),
                 ([(ND * 3, Np)], [(ND, Np, Np), (Np, F)])],
                [(3, N, Np), (N, F)], [div, dj2, sM, MI, LT, xi, Wd, Sel],
                [div, dj2, sM, MI, xi, Wd])
    vol3, dj3 = r(E_RAND, 3, N, Np), r(E_RAND, N, F)
    return (functools.partial(pallas_ldg._k_last, F=F),
            [([(3, N, Np), (N, F), (3, F), (Np,)], [(F, Np)])],
            [(3, N, Np)], [vol3, dj3, w3, MI, LT], [vol3, dj3, w3, MI])


STAGES = ["first", "grad_to_div", "div_to_grad", "last"]


@pytest.mark.parametrize("stage", STAGES)
def test_chain_stage_at_five_rows_matches_jax_kernel(setup, stage):
    fo = setup["rhs"].chain.fo
    body, groups, outs, jargs, targs = _stage_case(
        stage, fo, np.random.default_rng(20 + STAGES.index(stage)))
    ref = _pallas(body, groups, outs, jargs)
    targs = [torch.as_tensor(a) for a in targs] + [fo]
    got = ldg_kernel.PLAIN[STAGES.index(stage)](*targs)
    wrapped = ldg_kernel.KERNELS[STAGES.index(stage)](*targs)
    got = got if isinstance(got, tuple) else (got,)
    wrapped = wrapped if isinstance(wrapped, tuple) else (wrapped,)
    assert len(got) == len(ref)
    for g, w, r in zip(got, wrapped, ref):
        err = np.max(np.abs(g.numpy() - np.asarray(r))) \
            / np.max(np.abs(np.asarray(r)))
        assert err < TOL
        np.testing.assert_array_equal(w.numpy(), g.numpy())


def test_moist_chain_matches_jax_pallas_chain(setup):
    glv = setup["glv"]
    assert glv.shape[1] == N
    ref = pallas_ldg.chain_vm(setup["dg_j"], jnp.asarray(glv.numpy()), DIMS,
                              FACES, interpret=True, block_e=BLOCK_E)
    got = ldg_kernel.chain_vm(glv, setup["rhs"].chain)
    assert _rel_err_per_lane(got.reshape(ref.shape[0], -1, ref.shape[-1]),
                             np.asarray(ref).reshape(ref.shape[0], -1,
                                                     ref.shape[-1])
                             ).max() < 1e-11


# --- the volume and surface kernels at nq = 6 ---------------------------------------

def _volume_args(setup, has_f2):
    rhs, g = setup["rhs"], setup["rhs"].grid
    aux = setup["aux"]
    args = (setup["q"], setup["p"], aux[:, rhs.i_phi].contiguous(),
            aux[:, rhs.i_pref].contiguous(),
            torch.zeros((g.nelem, 3, g.Np), dtype=torch.float64),
            setup["gl2"] if has_f2 else torch.zeros(
                (g.nelem, 3, g.Np), dtype=torch.float64),
            rhs.nu if has_f2 else torch.zeros((g.nelem, 2, g.Np),
                                              dtype=torch.float64),
            rhs.xiv, g.M, g.MI, g.Wdiv)
    ps = rhs.bl.param_set
    kw = dict(nq=6, ngl=5 if has_f2 else 1, R_d=ps.R_d, cv_d=ps.cv_d,
              T_0=ps.T_0, subtract_ref=True, has_f2=has_f2)
    return args, kw


@pytest.mark.parametrize("has_f2", [True, False], ids=["f2", "no_f2"])
def test_moist_volume_matches_jax_kernel(setup, has_f2):
    args, kw = _volume_args(setup, has_f2)
    ref = np.asarray(jax_fused_volume_tendency_vm(
        *(jnp.asarray(a.numpy()) for a in args), block_e=BLOCK_E,
        interpret=True, **kw))
    got = volume_kernel.volume_tendency_plain(*args, **kw)
    assert got.shape == (args[0].shape[0], 6, args[0].shape[2])
    err = _rel_err_per_lane(got, ref)
    assert err.max() < TOL, err
    np.testing.assert_array_equal(
        volume_kernel.fused_volume_tendency_vm(*args, **kw).numpy(),
        got.numpy())


@pytest.mark.parametrize("hyper", [True, False], ids=["hyper", "no_hyper"])
def test_moist_surface_kernels_match_jax(setup, hyper):
    rhs, g = setup["rhs"], setup["rhs"].grid
    E, Np = g.nelem, g.Np
    p_ref = setup["aux"][:, rhs.i_pref].contiguous()
    ext_args = (setup["q"], setup["p"], setup["c_s"], p_ref[:, None],
                setup["gl2"] if hyper else torch.zeros((E, 3, Np),
                                                       dtype=torch.float64),
                rhs.nu if hyper else torch.zeros((E, 2, Np),
                                                 dtype=torch.float64),
                g.lift, rhs.nrm)
    ext_kw = dict(nq=6, na=1, ngl=5 if hyper else 1, has_hyper=hyper)
    Bf_ref = np.asarray(jax_extract_trace_vm(
        *(jnp.asarray(a.numpy()) for a in ext_args), block_e=BLOCK_E,
        interpret=True, **ext_kw))
    Bf = surface_kernel.extract_trace_plain(*ext_args, **ext_kw)
    assert Bf.shape[1] == 15 if hyper else 9
    assert _rel_err_per_lane(Bf, Bf_ref).max() < TOL
    np.testing.assert_array_equal(
        surface_kernel.extract_trace_vm(*ext_args, **ext_kw).numpy(),
        Bf.numpy())

    ps = rhs.bl.param_set
    lift_args = (Bf, rhs._gather_faces(Bf), rhs.nrm, rhs.sM, rhs.bmask,
                 rhs.liftT, g.MI)
    lift_kw = dict(nq=6, nvb=Bf.shape[1], subtract=True, i_pref=8,
                   has_hyper=hyper, rem_lanes=(), sl_lo=0, sl_hi=0,
                   R_d_T0=ps.R_d * ps.T_0, R_over_cv=ps.R_d / ps.cv_d)
    ref = np.asarray(jax_fused_surface_lift_vm(
        *(jnp.asarray(a.numpy()) for a in lift_args), block_e=BLOCK_E,
        interpret=True, **lift_kw))
    got = surface_kernel.surface_lift_plain(*lift_args, **lift_kw)
    err = _rel_err_per_lane(got, ref)
    assert got.shape[1] == 6 and err.max() < TOL, err
    np.testing.assert_array_equal(
        surface_kernel.fused_surface_lift_vm(*lift_args, **lift_kw).numpy(),
        got.numpy())


# --- what the CUDA wrappers still refuse ------------------------------------------

def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


#: (wrapper, keyword arguments) the CUDA kernels do not cover (a remainder
#: in "horizontal", lin_dims (0, 1), is covered; (1, 2) no direction
#: yields)
STILL_REFUSED = {
    "volume_nq7": ("volume", dict(nq=7, ngl=6, has_f2=True)),
    "volume_moist_lin_dims": ("volume", dict(nq=6, ngl=5, has_f2=True,
                                             lin_dims=(1, 2))),
    "volume_moist_ngl4": ("volume", dict(nq=6, ngl=4, has_f2=True)),
    "extract_nq7": ("extract", dict(nq=7, ngl=6)),
    "extract_moist_ngl4": ("extract", dict(nq=6, ngl=4)),
    "lift_nq7": ("lift", dict(nq=7, nvb=17, i_pref=9)),
    "lift_moist_rem_lanes": ("lift", dict(nq=6, nvb=18, i_pref=8,
                                          rem_lanes=(6, 7, 8), sl_lo=64,
                                          sl_hi=96)),
    "chain_n6": ("chain", dict(n=6)),
}


@pytest.mark.parametrize("case", list(STILL_REFUSED))
def test_cuda_wrappers_refuse_what_is_not_covered(case):
    """Each wrapper refuses a configuration its kernel does not cover
    before it looks at the device, and counts no launch."""
    which, kw = STILL_REFUSED[case]
    E, Np, X, F = 8, 64, 96, 64
    if which == "volume":
        nq, ngl = kw["nq"], kw["ngl"]
        call = lambda: volume_kernel.fused_volume_tendency_vm(
            _meta(E, nq, Np), _meta(E, Np), _meta(E, Np), _meta(E, Np),
            _meta(E, 3, Np), _meta(E, 3 * ngl, Np), _meta(E, 2, Np),
            _meta(E, 9, Np), _meta(E, Np), _meta(E, Np), _meta(Np, 3 * Np),
            R_d=287.0, cv_d=717.0, T_0=273.16, **kw)
        wrappers = [volume_kernel.fused_volume_tendency_vm]
    elif which == "extract":
        nq, ngl = kw["nq"], kw["ngl"]
        call = lambda: surface_kernel.extract_trace_vm(
            _meta(E, nq, Np), _meta(E, Np), _meta(E, Np), _meta(E, 1, Np),
            _meta(E, 3 * ngl, Np), _meta(E, 2, Np), _meta(Np, X),
            _meta(E, 3, X), na=1, has_hyper=True, **kw)
        wrappers = [surface_kernel.extract_trace_vm]
    elif which == "lift":
        nvb = kw["nvb"]
        args = dict(subtract=True, has_hyper=True, rem_lanes=(), sl_lo=0,
                    sl_hi=0, R_d_T0=1.0, R_over_cv=1.0)
        args.update(kw)
        call = lambda: surface_kernel.fused_surface_lift_vm(
            _meta(E, nvb, X), _meta(E, nvb, X), _meta(E, 3, X),
            _meta(E, 1, X), _meta(E, 1, X), _meta(X, Np), _meta(E, Np),
            **args)
        wrappers = [surface_kernel.fused_surface_lift_vm]
    else:
        n = kw["n"]
        i = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")
        fo = FaceOps(Sel=_meta(Np, F), LT=_meta(F, Np), sel_idx=i(F),
                     lift_idx=i(Np, 2))
        xi, Wd, MI = _meta(E, 6, Np), _meta(2, Np, Np), _meta(E, Np)
        calls = [
            lambda: ldg_kernel.ldg_first(_meta(E, n, Np), xi, Wd, fo),
            lambda: ldg_kernel.ldg_grad_to_div(
                _meta(E, 3, n, Np), _meta(E, n, F), _meta(E, 3, F),
                _meta(E, 3, F), MI, xi, Wd, fo),
            lambda: ldg_kernel.ldg_div_to_grad(
                _meta(E, n, Np), _meta(E, n, F), _meta(E, F), MI, xi, Wd,
                fo),
            lambda: ldg_kernel.ldg_last(_meta(E, 3, n, Np), _meta(E, n, F),
                                        _meta(E, 3, F), MI, fo)]
        wrappers = list(ldg_kernel.KERNELS)
        before = [w.launches for w in wrappers]
        for c in calls:
            with pytest.raises(NotImplementedError, match="rows"):
                c()
        assert [w.launches for w in wrappers] == before
        return
    before = [w.launches for w in wrappers]
    with pytest.raises(NotImplementedError):
        call()
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("which", ["volume", "extract", "lift", "chain"])
def test_moist_branches_reach_the_kernel_path(which):
    """A moist-width call off the CPU is no longer refused for its width:
    it goes to the kernel path, which refuses a non-CUDA device
    (ValueError) and counts no launch."""
    E, Np, X, F = 8, 64, 96, 64
    if which == "volume":
        wrapper = volume_kernel.fused_volume_tendency_vm
        call = lambda: wrapper(
            _meta(E, 6, Np), _meta(E, Np), _meta(E, Np), _meta(E, Np),
            _meta(E, 3, Np), _meta(E, 15, Np), _meta(E, 2, Np),
            _meta(E, 9, Np), _meta(E, Np), _meta(E, Np), _meta(Np, 3 * Np),
            nq=6, ngl=5, R_d=287.0, cv_d=717.0, T_0=273.16, has_f2=True)
    elif which == "extract":
        wrapper = surface_kernel.extract_trace_vm
        call = lambda: wrapper(
            _meta(E, 6, Np), _meta(E, Np), _meta(E, Np), _meta(E, 1, Np),
            _meta(E, 15, Np), _meta(E, 2, Np), _meta(Np, X), _meta(E, 3, X),
            nq=6, na=1, ngl=5, has_hyper=True)
    elif which == "lift":
        wrapper = surface_kernel.fused_surface_lift_vm
        call = lambda: wrapper(
            _meta(E, 15, X), _meta(E, 15, X), _meta(E, 3, X), _meta(E, 1, X),
            _meta(E, 1, X), _meta(X, Np), _meta(E, Np), nq=6, nvb=15,
            subtract=True, i_pref=8, has_hyper=True, rem_lanes=(), sl_lo=0,
            sl_hi=0, R_d_T0=1.0, R_over_cv=1.0)
    else:
        wrapper = ldg_kernel.ldg_first
        i = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")
        fo = FaceOps(Sel=_meta(Np, F), LT=_meta(F, Np), sel_idx=i(F),
                     lift_idx=i(Np, 2))
        call = lambda: wrapper(_meta(E, 5, Np), _meta(E, 6, Np),
                               _meta(2, Np, Np), fo)
    before = wrapper.launches
    with pytest.raises(ValueError):
        call()
    assert wrapper.launches == before
