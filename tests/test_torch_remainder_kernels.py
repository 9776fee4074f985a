"""The plain versions of the kernels' fused-remainder branches against
the JAX Pallas kernels run in interpret mode, in float64 on the CPU:

- ``dry_volume_tendency`` with ``lin_dims`` (0, 1) and (0, 1, 2), with
  and without ``lin_gravity``, on seeded physically scaled inputs (the
  inputs of tests/test_torch_dry_volume.py, which holds (), (2,) with
  and without gravity): the JAX kernel body with its weak-divergence dot
  at the inputs' precision, within 1e-12 of max|ref| per variable (the
  JAX kernel rounds that dot to float32 otherwise, pallas_volume.py:90-93);
- ``fused_volume_tendency_vm`` with ``lin_dims`` at the combinations
  tests/test_torch_volume.py does not hold: (2,) without gravity at
  nq = 6, (0, 1, 2) with gravity and F₂ at nq = 5, (0, 1, 2) without
  gravity with F₂ at nq = 6: 1e-12;
- ``extract_trace_vm`` at na = 4 (p_ref, φ, the linear energy
  coefficient and the reference sound speed) and ``fused_surface_lift_vm``
  with ``rem_lanes = (nq+3, nq+4, nq+5)`` on that bundle and its
  gathered neighbour side, with the linear faces of "vertical" (lanes
  [4·Nfp, 6·Nfp)) and of "every" (all), with hyperdiffusion on and off,
  nq = 5 and 6, on the n_horz=2, n_vert=2, p3 grid's face operators and
  seeded inputs: 1e-12 of each lane's or variable's largest magnitude.

On a CPU tensor each wrapper is its plain version, bit for bit; the CUDA
kernels are held against the plain versions on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg import pallas_volume as jax_pallas_volume
from climatemachine_tpu.dg.pallas_surface import \
    extract_trace_vm as jax_extract_trace_vm
from climatemachine_tpu.dg.pallas_surface import \
    fused_surface_lift_vm as jax_fused_surface_lift_vm
from climatemachine_tpu_torch.atmos.linear import \
    AtmosAcousticGravityLinearModel
from climatemachine_tpu_torch.dg import (dry_volume_kernel, surface_kernel,
                                        volume_kernel)
from climatemachine_tpu_torch.dg.fast_rhs import VarMajorRHS
from climatemachine_tpu_torch.dg.spatial import DGModel
from climatemachine_tpu_torch.experiments.held_suarez import \
    held_suarez_config
from climatemachine_tpu_torch.physics.parameters import EARTH

E, NP = 32, 64
TOL = 1e-12
KW = dict(R_d=EARTH.R_d, cv_d=EARTH.cv_d, T_0=EARTH.T_0)


def _rel_err(got, ref):
    """max |got − ref| per lane (axis 1) over max |ref| of it."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return (np.max(np.abs(got - ref), axis=(0, 2))
            / np.maximum(np.max(np.abs(ref), axis=(0, 2)), 1e-300))


def _volume_inputs(nq, ngl, seed):
    """Var-major inputs: ρ ~ 1, |u| <= 50, T in 200-300 K, φ up to 30 km
    of geopotential, p_ref within 1e-3 of p, ρq_tot up to 5e-3 ρ."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.1 * rng.standard_normal((E, NP))
    u = rng.uniform(-50.0, 50.0, (E, 3, NP))
    phi = EARTH.grav * rng.uniform(0, 3e4, (E, NP))
    e_int = EARTH.cv_d * (rng.uniform(200.0, 300.0, (E, NP)) - EARTH.T_0)
    rhoe = rho * (e_int + 0.5 * np.sum(u * u, axis=1) + phi)
    extra = [rho[:, None] * 1e-3 * rng.uniform(0, 5, (E, 1, NP))] * (nq - 5)
    qv = np.concatenate([rho[:, None], rho[:, None] * u, rhoe[:, None]]
                        + extra, axis=1)
    p = rho * EARTH.R_d * (EARTH.T_0 + e_int / EARTH.cv_d)
    p_ref = p * (1 + 1e-3 * rng.standard_normal((E, NP)))
    ref3 = np.stack([rho * (e_int + phi), rho, p_ref], axis=1)
    gl2 = 1e-12 * rng.standard_normal((E, 3 * ngl, NP))
    nu = 1e14 * rng.uniform(0.5, 1.5, (E, 2, NP))
    xiv = 1e-4 * rng.standard_normal((E, 9, NP))
    M = rng.uniform(1e9, 2e9, (E, NP))
    return dict(qv=qv, p=p, phi=phi, p_ref=p_ref, ref3=ref3, gl2=gl2, nu=nu,
                xiv=xiv, M=M, MI=1.0 / M,
                Wdiv=rng.standard_normal((NP, 3 * NP)))


# --- the dry volume kernel -------------------------------------------------------

DRY = [((0, 1), True), ((0, 1), False), ((0, 1, 2), True),
       ((0, 1, 2), False)]
DRY_IDS = ["horizontal-gravity", "horizontal-acoustic", "every-gravity",
           "every-acoustic"]


@pytest.mark.parametrize("lin_dims,lin_gravity", DRY, ids=DRY_IDS)
def test_dry_volume_remainder_matches_jax_kernel(monkeypatch, lin_dims,
                                                 lin_gravity):
    x = _volume_inputs(5, 1, seed=41 + DRY.index((lin_dims, lin_gravity)))
    args = [x[k] for k in ("qv", "phi", "p_ref", "ref3", "xiv", "M", "MI",
                           "Wdiv")]
    kw = dict(KW, lin_dims=lin_dims, lin_gravity=lin_gravity)
    targs = [torch.as_tensor(a) for a in args]
    got = dry_volume_kernel.dry_volume_tendency_plain(*targs, **kw).numpy()

    # the unjitted JAX kernel, node-major, its dot at the inputs' precision
    dot_general = jax.lax.dot_general
    monkeypatch.setattr(
        jax.lax, "dot_general",
        lambda *a, **k: dot_general(*a, **{**k,
                                           "preferred_element_type": None}))
    qv, phi, p_ref, ref3, xiv, M, MI, Wdiv = (jnp.asarray(a) for a in args)
    ref = jax_pallas_volume.dry_volume_tendency.__wrapped__(
        qv.transpose(0, 2, 1), phi, p_ref, ref3, xiv.transpose(0, 2, 1), M,
        MI, Wdiv, interpret=True, **kw)
    monkeypatch.undo()
    err = _rel_err(got, np.asarray(ref).transpose(0, 2, 1))
    assert err.max() < TOL, err
    np.testing.assert_array_equal(
        dry_volume_kernel.dry_volume_tendency(*targs, **kw).numpy(), got)


# --- the var-major volume kernel --------------------------------------------------

# (nq, has_f2, lin_dims, lin_gravity)
VOLUME = {"vertical-acoustic-nq6": (6, False, (2,), False),
          "every-gravity-f2": (5, True, (0, 1, 2), True),
          "every-acoustic-f2-nq6": (6, True, (0, 1, 2), False)}


@pytest.mark.parametrize("case", list(VOLUME))
def test_volume_remainder_matches_jax_kernel(case):
    nq, has_f2, lin_dims, lin_gravity = VOLUME[case]
    ngl = nq - 1 if has_f2 else 1
    x = _volume_inputs(nq, ngl, seed=51 + list(VOLUME).index(case))
    args = [x[k] for k in ("qv", "p", "phi", "p_ref", "ref3", "gl2", "nu",
                           "xiv", "M", "MI", "Wdiv")]
    kw = dict(KW, nq=nq, ngl=ngl, subtract_ref=True, has_f2=has_f2,
              lin_dims=lin_dims, lin_gravity=lin_gravity)
    ref = jax_pallas_volume.fused_volume_tendency_vm(
        *(jnp.asarray(a) for a in args), block_e=E, interpret=True, **kw)
    targs = [torch.as_tensor(a) for a in args]
    got = volume_kernel.volume_tendency_plain(*targs, **kw)
    err = _rel_err(got, ref)
    assert err.max() < TOL, err
    np.testing.assert_array_equal(
        volume_kernel.fused_volume_tendency_vm(*targs, **kw).numpy(),
        got.numpy())


# --- the surface kernels at na = 4 ------------------------------------------------

@pytest.fixture(scope="module")
def surface_ops():
    """A remainder's var-major RHS on the n_horz=2, n_vert=2, p3 grid: its
    face operators and neighbour tables."""
    cfg = held_suarez_config(2, 2, 3, dtype=torch.float64, device="cpu")
    lin = AtmosAcousticGravityLinearModel(cfg.model)
    return {ldir: VarMajorRHS(DGModel(cfg.model, cfg.grid,
                                      remainder=(lin, ldir)))
            for ldir in ("vertical", "every")}


# (nq, hyperdiffusion, direction of the linear model)
SURFACE = {"vertical-hyper": (5, True, "vertical"),
           "every-no_hyper": (5, False, "every"),
           "every-hyper-nq6": (6, True, "every"),
           "vertical-no_hyper-nq6": (6, False, "vertical")}


@pytest.mark.parametrize("case", list(SURFACE))
def test_surface_remainder_matches_jax_kernels(surface_ops, case):
    nq, hyper, ldir = SURFACE[case]
    rhs = surface_ops[ldir]
    g = rhs.grid
    Ec, Np, X = g.nelem, g.Np, rhs.nrm.shape[2]
    rng = np.random.default_rng(61 + list(SURFACE).index(case))
    rho = 1.0 + 0.1 * rng.standard_normal((Ec, Np))
    q = np.concatenate(
        [rho[:, None], rho[:, None] * rng.uniform(-50, 50, (Ec, 3, Np)),
         rho[:, None] * (2.5e5 + 1e4 * rng.standard_normal((Ec, 1, Np)))]
        + [rho[:, None] * 1e-3 * rng.uniform(0, 5, (Ec, 1, Np))] * (nq - 5),
        axis=1)
    p = 1e5 * (1 + 0.05 * rng.standard_normal((Ec, Np)))
    c_s = rng.uniform(280.0, 350.0, (Ec, Np))
    aux4 = np.stack([p * (1 + 1e-3 * rng.standard_normal((Ec, Np))),
                     9.81 * rng.uniform(0, 3e4, (Ec, Np)),
                     rng.uniform(2e5, 3e5, (Ec, Np)),
                     rng.uniform(280.0, 350.0, (Ec, Np))], axis=1)
    ngl = nq - 1 if hyper else 1
    gl2 = 1e-12 * rng.standard_normal((Ec, 3 * ngl, Np))
    nu = 1e14 * rng.uniform(0.5, 1.5, (Ec, 2, Np))
    ext_args = [torch.as_tensor(a) for a in (q, p, c_s, aux4, gl2, nu)] + [
        g.lift, rhs.nrm]
    ext_kw = dict(nq=nq, na=4, ngl=ngl, has_hyper=hyper)
    Bf_ref = jax_extract_trace_vm(*(jnp.asarray(a.numpy()) for a in ext_args),
                                  block_e=Ec, interpret=True, **ext_kw)
    Bf = surface_kernel.extract_trace_plain(*ext_args, **ext_kw)
    assert Bf.shape == (Ec, nq + 6 + nq * hyper, X)
    assert _rel_err(Bf, Bf_ref).max() < TOL
    np.testing.assert_array_equal(
        surface_kernel.extract_trace_vm(*ext_args, **ext_kw).numpy(),
        Bf.numpy())

    sl_lo, sl_hi = rhs.lin_lanes
    assert (sl_lo, sl_hi) == ((4 * g.Nfp_max, 6 * g.Nfp_max)
                              if ldir == "vertical" else (0, X))
    ps = rhs.bl.param_set
    lift_args = (Bf, rhs._gather_faces(Bf), rhs.nrm, rhs.sM, rhs.bmask,
                 rhs.liftT, g.MI)
    lift_kw = dict(nq=nq, nvb=Bf.shape[1], subtract=True, i_pref=nq + 2,
                   has_hyper=hyper, rem_lanes=(nq + 3, nq + 4, nq + 5),
                   sl_lo=sl_lo, sl_hi=sl_hi, R_d_T0=ps.R_d * ps.T_0,
                   R_over_cv=ps.R_d / ps.cv_d)
    ref = jax_fused_surface_lift_vm(
        *(jnp.asarray(a.numpy()) for a in lift_args), block_e=Ec,
        interpret=True, **lift_kw)
    got = surface_kernel.surface_lift_plain(*lift_args, **lift_kw)
    err = _rel_err(got, ref)
    assert got.shape == (Ec, nq, Np) and err.max() < TOL, err
    np.testing.assert_array_equal(
        surface_kernel.fused_surface_lift_vm(*lift_args, **lift_kw).numpy(),
        got.numpy())
    # the linear faces' flux changes the result
    no_rem = surface_kernel.surface_lift_plain(
        *lift_args, **dict(lift_kw, rem_lanes=()))
    assert _rel_err(no_rem, got).max() > 1e-6
