"""The port's generic DG operator for the full Held-Suarez AtmosModel
against the JAX package, in float64 on the CPU at n_horz=2, n_vert=2, p3
on the JAX grid's arrays, from a seeded perturbation of the JAX initial
state, with hyperdiffusion off and with DryBiharmonic(8 h):

- the model's hooks (flux_first_order, wavespeed, the gradient-Laplacian
  argument, the hyperdiffusive transform and flux, each source's
  ``contributions``) against JAX's, 1e-12 relative, transposing the JAX
  package's node-major tensors (interop.to_var_major);
- the RHS ``DGModel(...)(q, aux, t)`` under every combination of
  ``volume_kernel`` ("pallas": the dry kernel's plain version; "xla": the
  contraction), ``ldg_kernel`` ("auto": the chain stages' plain versions;
  "varmajor": the per-pass chain) and ``surface_kernel`` ("auto": the
  var-major surface pass; "xla": the node-gather pass) against JAX
  ``DGModel(..., volume_kernel="xla", surface_kernel="varmajor")``,
  1e-11 relative per variable (tests/test_fast_rhs.py:53), and against
  JAX ``DGModel(..., volume_kernel="pallas", surface_kernel="varmajor")``
  with its Pallas volume kernel in interpret mode, 1e-6: that kernel
  rounds its contraction to float32 under float64
  (tests/test_torch_dry_volume.py), 5.5e-8 measured;
- ``remainder_DGModel`` (the fused IMEX remainder over the vertical
  acoustic-gravity model) against JAX's (1e-10 per variable) and against
  the two-call difference ``dg(q) − dg_lin(q)`` (1e-10, as
  tests/test_imex.py:151 holds JAX's).

The JAX RHS are computed once per fixture, in one jitted program (eager
dispatch costs 3-8 s a RHS on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.atmos.linear import \
    AtmosAcousticGravityLinearModel as JaxLinear
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init_ode_state
from climatemachine_tpu.dg.spatial import \
    remainder_DGModel as jax_remainder_DGModel
from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu_torch.atmos.linear import \
    AtmosAcousticGravityLinearModel
from climatemachine_tpu_torch.dg.spatial import DGModel, remainder_DGModel
from climatemachine_tpu_torch.experiments.held_suarez import \
    held_suarez_config
from climatemachine_tpu_torch.interop import (grid_from_numpy,
                                              grid_to_numpy,
                                              state_from_numpy,
                                              state_to_numpy, to_node_major,
                                              to_var_major)

SIZE = dict(n_horz=2, n_vert=2, poly_order=3)
OPTIONS = [dict(volume_kernel=v, ldg_kernel=l, surface_kernel=s)
           for v in ("pallas", "xla") for l in ("auto", "varmajor")
           for s in ("auto", "xla")]


@pytest.fixture(scope="module", params=[None, 8 * 3600.0],
                ids=["hd_off", "hd_on"])
def setup(request):
    """JAX config and perturbed state with its aux refreshed, the JAX
    RHS (XLA and Pallas volume, var-major surface pass) and remainder
    there; the port's model on the JAX grid's arrays."""
    tau = request.param
    cfg_j = jax_held_suarez_config(dtype=np.float64, hyperdiffusion_tau=tau,
                                   **SIZE)
    dg_j = JaxDGModel(cfg_j.model, cfg_j.grid, volume_kernel="xla",
                      surface_kernel="varmajor")
    q0, aux0 = jax_init_ode_state(dg_j)
    rng = np.random.default_rng(17)
    q = jnp.asarray(np.asarray(q0) * (1 + 1e-3 * rng.standard_normal(
        q0.shape)))
    aux = cfg_j.model.update_auxiliary_state(cfg_j.grid, q, aux0, 0.0)
    dg_p = JaxDGModel(cfg_j.model, cfg_j.grid, volume_kernel="pallas",
                      surface_kernel="varmajor")
    lin_j = JaxDGModel(JaxLinear(cfg_j.model), cfg_j.grid,
                       direction="vertical", update_aux=False)
    rem_j = jax_remainder_DGModel(dg_j, lin_j)
    # one jitted program: one compilation, faster than eager dispatch
    (rhs_xla, aux_rhs), (rhs_pallas, _), (rem, _) = jax.jit(
        lambda q, a: tuple(dg(q, a, 0.0) for dg in (dg_j, dg_p, rem_j)))(
            q, aux0)

    cfg_t = held_suarez_config(dtype=torch.float64, hyperdiffusion_tau=tau,
                               device="cpu", **SIZE)
    grid_t = grid_from_numpy(grid_to_numpy(cfg_j.grid), device="cpu",
                             dtype=torch.float64)
    qt, auxt = state_from_numpy(q, aux0, device="cpu")
    return dict(tau=tau, cfg_j=cfg_j, q=q, aux=aux, aux0=aux0,
                rhs_xla=to_var_major(rhs_xla, "cpu"),
                rhs_pallas=to_var_major(rhs_pallas, "cpu"),
                aux_rhs=to_var_major(aux_rhs, "cpu"),
                rem=to_var_major(rem, "cpu"), cfg_t=cfg_t, grid_t=grid_t,
                qt=qt, auxt=auxt)


def _rel_err_per_var(got, ref, axes=(0, 2)):
    """max |got − ref| per variable, relative to max |ref| of that
    variable."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.maximum(np.max(np.abs(ref), axis=axes), 1e-300)
    return np.max(np.abs(got - ref), axis=axes) / scale


def test_interop_layouts_round_trip(setup):
    q, aux = state_to_numpy(setup["qt"], setup["auxt"])
    np.testing.assert_array_equal(q, np.asarray(setup["q"]))
    np.testing.assert_array_equal(aux, np.asarray(setup["aux0"]))
    np.testing.assert_array_equal(to_node_major(setup["qt"]), q)


def test_model_hooks_match_jax(setup):
    """First-order flux and wavespeed on the volume nodes, the
    gradient-Laplacian argument, the hyperdiffusive transform and flux
    of a seeded ∇Δ, and each source's contributions."""
    mj, mt = setup["cfg_j"].model, setup["cfg_t"].model
    q, aux = setup["q"], setup["aux"]
    qt, auxt = state_from_numpy(q, aux, device="cpu")
    Fj = np.asarray(mj.flux_first_order(q, aux, 0.0))     # [E, Np, 3, n]
    Ft = mt.flux_first_order(qt, auxt, 0.0).numpy()       # [E, 3, n, Np]
    assert _rel_err_per_var(Ft.transpose(0, 3, 1, 2), Fj,
                            axes=(0, 1)).max() < 1e-12
    nrm = np.random.default_rng(3).standard_normal(q.shape[:2] + (3,))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    cj = np.asarray(mj.wavespeed(jnp.asarray(nrm), q, aux, 0.0))
    ct = mt.wavespeed(torch.as_tensor(nrm).transpose(1, 2), qt, auxt, 0.0)
    assert np.max(np.abs(ct.numpy() - cj)) < 1e-12 * np.max(np.abs(cj))
    for src_t, src_j in zip(mt.sources, mj.sources):
        want = src_j.contributions(mj, q, None, aux, 0.0)
        got = src_t.contributions(mt, qt, None, auxt, 0.0)
        assert set(got) == set(want)
        for name, val in got.items():
            ref = np.asarray(want[name])
            val = val.numpy()
            val = val.transpose(0, 2, 1) if val.ndim == 3 else val
            assert np.max(np.abs(val - ref)) <= 1e-12 * np.max(np.abs(ref))
    if setup["tau"] is None:
        return
    glj = mj.compute_gradient_laplacian_argument(q, aux, 0.0)
    glt = mt.compute_gradient_laplacian_argument(qt, auxt, 0.0)
    assert _rel_err_per_var(glt, to_var_major(glj, "cpu")).max() < 1e-12
    grad_lap = np.random.default_rng(5).standard_normal(
        q.shape[:2] + (3, 4)) * 1e-12                     # [E, Np, 3, n]
    hyj = mj.transform_post_gradient_laplacian(jnp.asarray(grad_lap), q,
                                               aux, 0.0)
    hyt = mt.transform_post_gradient_laplacian(
        torch.as_tensor(grad_lap).permute(0, 2, 3, 1), qt, auxt, 0.0)
    # JAX hyper lanes: ν₄∇Δu_h at 3·i + j, then ν₄∇Δh_tot at 9 + i
    lanes = torch.cat([hyt[:, :, :3].flatten(1, 2), hyt[:, :, 3]], dim=1)
    assert _rel_err_per_var(lanes.transpose(1, 2), hyj,
                            axes=(0, 1)).max() < 1e-12
    F2j = np.asarray(mj.flux_second_order(q, None, hyj, aux, 0.0))
    F2t = mt.flux_second_order(qt, None, hyt, auxt, 0.0).numpy()
    assert _rel_err_per_var(F2t.transpose(0, 3, 1, 2)[..., 1:], F2j[..., 1:],
                            axes=(0, 1)).max() < 1e-12
    assert not F2t[:, :, 0].any()


@pytest.mark.parametrize("options", OPTIONS, ids=lambda o: "-".join(
    o.values()))
def test_rhs_matches_jax(setup, options):
    dg = DGModel(setup["cfg_t"].model, setup["grid_t"], **options)
    assert dg.dry_volume == (options["volume_kernel"] == "pallas")
    assert dg.fast_surface == (options["surface_kernel"] == "auto")
    tend, aux = dg(setup["qt"], setup["auxt"], 0.0)
    err = _rel_err_per_var(tend, setup["rhs_xla"])
    assert err.max() < 1e-11, err
    err32 = _rel_err_per_var(tend, setup["rhs_pallas"])
    assert err32.max() < 1e-6, err32
    assert _rel_err_per_var(aux, setup["aux_rhs"]).max() < 1e-12


@pytest.mark.parametrize("volume_kernel", ["pallas", "xla"])
def test_remainder_matches_jax_and_difference(setup, volume_kernel):
    model, grid = setup["cfg_t"].model, setup["grid_t"]
    dg = DGModel(model, grid, volume_kernel=volume_kernel)
    dg_lin = DGModel(AtmosAcousticGravityLinearModel(model), grid,
                     direction="vertical", update_aux=False)
    dg_rem = remainder_DGModel(dg, dg_lin)
    assert dg_rem.remainder == (dg_lin.balance_law, "vertical")
    assert dg_rem.dry_volume == (volume_kernel == "pallas")
    q, aux = setup["qt"], setup["auxt"]
    rem, _ = dg_rem(q, aux, 0.0)
    err = _rel_err_per_var(rem, setup["rem"])
    assert err.max() < 1e-10, err
    full, aux1 = dg(q, aux, 0.0)
    lin, _ = dg_lin(q, aux1, 0.0)
    err = _rel_err_per_var(rem, full - lin)
    assert err.max() < 1e-10, err
