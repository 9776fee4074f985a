"""HydrostaticBoussinesqModel in the port against the JAX package's, in
float64 on the CPU (tests/ocean_parity.py: the stacked 3 × 2 × 3 box at
p3, uneven layers), from the initial state plus noise (numpy seed 0):

- the generic ``DGModel`` RHS after ``pre_stage`` (the vertical cut-off
  on u, the exponential filter on θ) and the aux it returns, the stack
  integrals w, pkin and wz0 among them, each within 1e-11 per variable
  of the JAX result's largest magnitude, for HomogeneousBox (no-slip
  coasts, a free-slip floor, KinematicStress), OceanGyre
  (TemperatureFlux and the convective adjustment), SimpleBox under
  Fixed and Rotating, with ``momentum_advection`` None and
  "nonlinear", with the vertical filters on and off;
- the gradient flux κ∇θ of the homogeneous box (uniform θ: ∂θ/∂z is
  round-off, so each package's choice of κ is arbitrary there but κ∇θ
  is ~1e-16 either way);
- ``LinearHBModel``'s RHS in the vertical direction;
- the Rusanov flux with ``numerical_flux_penalty`` (η takes no
  dissipation) against the JAX flux, and ``SimpleBox.hb_state`` at t > 0
  (``torch.linalg.matrix_exp`` against the JAX ``expm``);
- the state and aux carried across by interop.py with their lane names,
  and the DG operator's paths: no dry kernel, no var-major surface
  pass, no wall diffusive flux.
"""

import jax
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.numerical_fluxes import \
    RusanovNumericalFlux as JaxRusanov
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init
from climatemachine_tpu.ocean.hydrostatic_boussinesq import \
    LinearHBModel as JaxLinearHB
from climatemachine_tpu_torch.dg.numerical_fluxes import (
    CentralNumericalFluxFirstOrder, RusanovNumericalFlux)
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.interop import state_from_numpy, state_to_numpy
from climatemachine_tpu_torch.ocean.hydrostatic_boussinesq import \
    LinearHBModel
from ocean_parity import grids, models, nm, perturbed, rel_err_per_var, vm

TOL = 1e-11
AUX = ("w", "pkin", "wz0")

CASES = {
    "homogeneous": ("homogeneous", {}),
    "gyre": ("gyre", {}),
    "simplebox_fixed": ("simplebox_fixed", {}),
    "simplebox_rotating": ("simplebox_rotating", {}),
    "gyre_momentum_advection": ("gyre", dict(momentum_advection="nonlinear")),
    "homogeneous_no_filters": ("homogeneous",
                               dict(apply_vert_filters=False)),
    "simplebox_linear_tracers": ("simplebox_rotating",
                                 dict(tracer_advection=None,
                                      momentum_advection="nonlinear")),
}


@pytest.fixture(scope="module")
def grid_pair():
    return grids()


def _pair(case, grid_pair):
    name, kw = CASES[case]
    mj, mt = models(name, **kw)
    gj, gt = grid_pair
    dj, dt_ = JaxDGModel(mj, gj), DGModel(mt, gt)
    qj, aj = jax_init(dj)
    qt, at = init_ode_state(dt_)
    return mj, mt, dj, dt_, (qj, aj), (qt, at)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rhs_and_stack_integrals_match_jax(case, grid_pair):
    mj, mt, dj, dt_, (qj, aj), (qt, at) = _pair(case, grid_pair)
    assert max(rel_err_per_var(nm(qt), qj)) < TOL
    assert max(rel_err_per_var(nm(at), aj)) < TOL
    q = perturbed(qj)

    @jax.jit
    def jax_rhs(q, aux):
        q = dj.pre_stage(q, aux, 30.0)
        tend, aux = dj(q, aux, 30.0)
        return q, tend, aux

    qp_j, tend_j, aux_j = jax_rhs(q, aj)
    qp_t = dt_.pre_stage(vm(q), at, 30.0)
    tend_t, aux_t = dt_(qp_t, at, 30.0)
    assert max(rel_err_per_var(nm(qp_t), qp_j)) < TOL
    err = rel_err_per_var(nm(tend_t), tend_j)
    assert max(err) < TOL, err
    aux_err = rel_err_per_var(nm(aux_t), aux_j)
    assert max(aux_err) < TOL, dict(zip(mt.aux_spec.flattened_names(),
                                        aux_err))
    for name in AUX:     # the stack integrals are not trivially zero
        assert np.abs(np.asarray(aux_j)[..., mt.aux_spec.index(name)]).max() \
            > 0


def test_homogeneous_kappa_grad_theta(grid_pair):
    mj, mt, dj, dt_, (qj, aj), (qt, at) = _pair("homogeneous", grid_pair)
    gj = jax.jit(lambda q, a: mj.compute_gradient_flux(
        dj.spatial_gradient(q, a, 0.0), q, a, 0.0))(qj, aj)
    gt = mt.compute_gradient_flux(dt_.spatial_gradient(qt, at, 0.0), qt, at,
                                  0.0)
    sl = mt.gf_spec.index("kappa_grad_theta")
    kj, kt = np.asarray(gj)[..., sl], nm(gt)[..., sl]
    assert np.abs(kj).max() < 1e-12 and np.abs(kt).max() < 1e-12
    rest = [i for i in range(mt.gf_spec.num) if i not in range(sl.start,
                                                               sl.stop)]
    assert np.abs(nm(gt)[..., rest] - np.asarray(gj)[..., rest]).max() \
        < 1e-13


def test_linear_hb_vertical_rhs(grid_pair):
    mj, mt, _, _, _, _ = _pair("gyre", grid_pair)
    gj, gt = grid_pair
    dj = JaxDGModel(JaxLinearHB(mj), gj, direction="vertical")
    dt_ = DGModel(LinearHBModel(mt), gt, direction="vertical")
    qj, aj = jax_init(JaxDGModel(mj, gj))
    q = perturbed(qj, seed=3)
    tend_j, aux_j = jax.jit(lambda q, a: dj(q, a, 0.0))(q, aj)
    tend_t, aux_t = dt_(vm(q), vm(aj), 0.0)
    assert max(rel_err_per_var(nm(tend_t), tend_j)) < TOL
    np.testing.assert_array_equal(nm(aux_t), np.asarray(aux_j))


def _faces(gt, seed):
    """Random face states ``[E, n, X]``/aux and unit normals."""
    rng = np.random.default_rng(seed)
    E, X = gt.nelem, 20
    nrm = rng.standard_normal((E, 3, X))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    q = [rng.standard_normal((E, 4, X)) for _ in range(2)]
    aux = [rng.standard_normal((E, 11, X)) for _ in range(2)]
    return nrm, q, aux


def test_rusanov_penalty_matches_jax(grid_pair):
    mj, mt, _, _, _, _ = _pair("gyre", grid_pair)
    _, gt = grid_pair
    nrm, (qM, qP), (aM, aP) = _faces(gt, 4)
    t = lambda a: torch.from_numpy(a)
    nmj = lambda a: jax.numpy.asarray(np.moveaxis(a, 1, -1))
    got = RusanovNumericalFlux()(mt, t(nrm), t(qM), t(aM), t(qP), t(aP), 0.)
    ref = JaxRusanov()(mj, nmj(nrm), nmj(qM), nmj(aM), nmj(qP), nmj(aP), 0.)
    assert max(rel_err_per_var(np.moveaxis(got.numpy(), 1, -1), ref)) < 1e-14
    central = CentralNumericalFluxFirstOrder()(mt, t(nrm), t(qM), t(aM),
                                               t(qP), t(aP), 0.)
    ie = mt.prog_spec.index("eta").start
    assert torch.equal(got[:, ie], central[:, ie])
    assert not torch.allclose(got[:, 0], central[:, 0])


@pytest.mark.parametrize("case", ["simplebox_fixed", "simplebox_rotating"])
def test_simplebox_hb_state_at_t(case, grid_pair):
    """Against the JAX ``hb_state`` at 0, 1 h and 1 d; the rotating
    baroclinic deviation (u₀, v₀) at 1 d against its closed form
    e^{−λt}(cos ft ± sin ft)·cos(k_z z) sin(k_x x) instead: there the
    JAX ``expm`` of ||M t|| = 8.6 is 1e-10 off the closed form (about
    1e-7 of u₀'s 7.8e-4), ``torch.linalg.matrix_exp`` 2e-15."""
    mj, mt, _, _, _, _ = _pair(case, grid_pair)
    gj, gt = grid_pair
    x, z = gt.coords[..., 0].numpy(), gt.coords[..., 2].numpy()
    for t in (0.0, 3600.0, 86400.0):
        ref = [np.asarray(r) for r in mj.problem.hb_state(mj, gj.coords, t)]
        got = mt.problem.hb_state(mt, gt.coords.transpose(1, 2), t)
        if case == "simplebox_rotating" and t == 86400.0:
            kx, kz = 2 * np.pi / mt.problem.Lx, 2 * np.pi / mt.problem.H
            lam = mt.nu_h * kx ** 2 + mt.nu_z * kz ** 2
            ft, shape = mt.f_o * t, np.cos(kz * z) * np.sin(kx * x)
            ref[3:] = [np.exp(-lam * t) * (np.cos(ft) + sgn * np.sin(ft))
                       * shape for sgn in (1.0, -1.0)]
        for g, r in zip(got, ref):
            assert np.abs(g.numpy() - r).max() <= TOL * max(
                np.abs(r).max(), 1e-300)


def test_state_carried_across_with_lane_names(grid_pair):
    mj, mt, dj, _, (qj, aj), _ = _pair("gyre", grid_pair)
    names = (mj.prog_spec.flattened_names(), mj.aux_spec.flattened_names())
    assert names[0] == ["u[0]", "u[1]", "eta", "theta"]
    assert names[1][:4] == ["coord[0]", "coord[1]", "coord[2]", "y"]
    q, aux = state_from_numpy(qj, aj, device="cpu", model=mt, names=names)
    back = state_to_numpy(q, aux, model=mt)
    np.testing.assert_array_equal(back[0], np.asarray(qj))
    np.testing.assert_array_equal(back[1], np.asarray(aj))
    with pytest.raises(ValueError, match="lanes"):
        state_from_numpy(qj, aj, device="cpu", model=mt,
                         names=(names[0][::-1], names[1]))


def test_generic_paths_only(grid_pair):
    _, mt, _, dt_, _, _ = _pair("gyre", grid_pair)
    assert dt_.n_gradient == 3
    assert not dt_.dry_volume and not dt_.fast_surface
    assert not hasattr(mt, "boundary_flux_second_order")
    assert mt.gradlap_spec.num == 0
