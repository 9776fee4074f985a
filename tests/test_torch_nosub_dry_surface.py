"""The plain versions of the dry volume kernel's and the surface
kernels' branches without the reference pressure taken out, against the
JAX Pallas kernels run in interpret mode, in float64 on the CPU:

- ``dry_volume_tendency`` with ``subtract_ref=False`` and ``lin_dims``
  (), (2,) without gravity, (0, 1) with and (0, 1, 2) without, on the
  seeded, physically scaled inputs of
  tests/test_torch_remainder_kernels.py, the JAX kernel body with its
  weak-divergence dot at the inputs' precision (it rounds that dot to
  float32 otherwise, pallas_volume.py:90-93): 1e-12 of max|ref| per
  variable;
- ``extract_trace_vm`` at na = 0 (the bundle q, p, c and, with
  hyperdiffusion, the trace lanes) and ``fused_surface_lift_vm`` with
  ``subtract=False`` on that bundle (i_pref = nq, as the var-major RHS
  passes it) and on a remainder's na = 4 bundle (i_pref = nq + 2), at
  nq = 5 and 6, with and without hyperdiffusion, on the n_horz=2,
  n_vert=2, p3 grid's face operators: 1e-12 of each lane's or
  variable's largest magnitude.

Each case also checks that the branch differs from the one with p_ref
taken out (where the bundle has it), and that the wrapper on a CPU
tensor is its plain version bit for bit; the CUDA kernels are held
against the plain versions on the card by chip_smoke.py.  The var-major
volume kernel's branches are in tests/test_torch_nosub_kernels.py.
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
from climatemachine_tpu_torch.dg import dry_volume_kernel, surface_kernel
from climatemachine_tpu_torch.dg.fast_rhs import VarMajorRHS
from climatemachine_tpu_torch.dg.spatial import DGModel
from climatemachine_tpu_torch.experiments.held_suarez import \
    held_suarez_config
from test_torch_remainder_kernels import KW, TOL, _rel_err, _volume_inputs


# --- the dry volume kernel -------------------------------------------------------

DRY = {"none": ((), True), "vertical-acoustic": ((2,), False),
       "horizontal-gravity": ((0, 1), True),
       "every-acoustic": ((0, 1, 2), False)}


@pytest.mark.parametrize("case", list(DRY))
def test_dry_volume_nosub_matches_jax_kernel(monkeypatch, case):
    lin_dims, lin_gravity = DRY[case]
    x = _volume_inputs(5, 1, seed=71 + list(DRY).index(case))
    args = [x[k] for k in ("qv", "phi", "p_ref", "ref3", "xiv", "M", "MI",
                           "Wdiv")]
    kw = dict(KW, subtract_ref=False, lin_dims=lin_dims,
              lin_gravity=lin_gravity)
    targs = [torch.as_tensor(a) for a in args]
    got = dry_volume_kernel.dry_volume_tendency_plain(*targs, **kw).numpy()

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
    # p_ref is not read: the branch is the same without it
    targs[2] = None
    np.testing.assert_array_equal(
        dry_volume_kernel.dry_volume_tendency(*targs, **kw).numpy(), got)
    sub = dry_volume_kernel.dry_volume_tendency_plain(
        *[torch.as_tensor(a) for a in args], **dict(kw, subtract_ref=True))
    assert _rel_err(sub, got).max() > 1e-6


# --- the surface kernels ------------------------------------------------------------

@pytest.fixture(scope="module")
def surface_ops():
    """The face operators and neighbour tables of the var-major RHS on the
    n_horz=2, n_vert=2, p3 grid, and its vertical remainder's face
    lanes."""
    cfg = held_suarez_config(2, 2, 3, dtype=torch.float64, device="cpu")
    lin = AtmosAcousticGravityLinearModel(cfg.model)
    return VarMajorRHS(DGModel(cfg.model, cfg.grid,
                               remainder=(lin, "vertical")))


# (nq, hyperdiffusion, na: 0 the vortex's bundle, 4 a remainder's)
SURFACE = {"na0": (5, False, 0), "na0-hyper-nq6": (6, True, 0),
           "na4-hyper": (5, True, 4), "na4-nq6": (6, False, 4)}


@pytest.mark.parametrize("case", list(SURFACE))
def test_surface_nosub_matches_jax_kernels(surface_ops, case):
    nq, hyper, na = SURFACE[case]
    rhs = surface_ops
    g = rhs.grid
    Ec, Np, X = g.nelem, g.Np, rhs.nrm.shape[2]
    rng = np.random.default_rng(91 + list(SURFACE).index(case))
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
                     rng.uniform(280.0, 350.0, (Ec, Np))], axis=1)[:, :na]
    ngl = nq - 1 if hyper else 1
    gl2 = 1e-12 * rng.standard_normal((Ec, 3 * ngl, Np))
    nu = 1e14 * rng.uniform(0.5, 1.5, (Ec, 2, Np))
    ext_args = [torch.as_tensor(a) for a in (q, p, c_s, aux4, gl2, nu)] + [
        g.lift, rhs.nrm]
    ext_kw = dict(nq=nq, na=na, ngl=ngl, has_hyper=hyper)
    jax_aux = aux4 if na else np.zeros((Ec, 1, Np))    # as fast_rhs.py:436
    Bf_ref = jax_extract_trace_vm(
        *(jnp.asarray(a) for a in (q, p, c_s, jax_aux, gl2, nu,
                                   g.lift.numpy(), rhs.nrm.numpy())),
        block_e=Ec, interpret=True, **ext_kw)
    Bf = surface_kernel.extract_trace_plain(*ext_args, **ext_kw)
    assert Bf.shape == (Ec, nq + 2 + na + nq * hyper, X)
    assert _rel_err(Bf, Bf_ref).max() < TOL
    np.testing.assert_array_equal(
        surface_kernel.extract_trace_vm(*ext_args, **ext_kw).numpy(),
        Bf.numpy())

    ps = rhs.bl.param_set
    sl_lo, sl_hi = rhs.lin_lanes
    lift_args = (Bf, rhs._gather_faces(Bf), rhs.nrm, rhs.sM, rhs.bmask,
                 rhs.liftT, g.MI)
    lift_kw = dict(nq=nq, nvb=Bf.shape[1], subtract=False,
                   i_pref=nq + 2 if na else nq, has_hyper=hyper,
                   rem_lanes=(nq + 3, nq + 4, nq + 5) if na else (),
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
    if na:
        # p_ref from its lane changes the result
        sub = surface_kernel.surface_lift_plain(
            *lift_args, **dict(lift_kw, subtract=True))
        assert _rel_err(sub, got).max() > 1e-6
