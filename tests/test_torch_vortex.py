"""The isentropic vortex in the port against the JAX package, in float64
on the CPU, at tests/test_isentropic_vortex.py's ``_setup(4, 4)``: a
periodic 4 × 4 × 1 brick on [−L, L]³ at p4, NoOrientation, the
AtmosPhysics default NoReferenceState (the reference pressure is not
taken out of the momentum flux), dry Euler.

- the brick grid (metrics, faces, periodic neighbours, min node
  distance) and the initial state and aux;
- the generic DG operator's RHS with the Rusanov, Roe and HLLC fluxes;
- the var-major RHS under the surface passes "xla", "hybrid" and
  "pallas" (the kernels' plain versions on the CPU: ``subtract_ref=False``
  in the volume kernel, na = 0 in the extraction, ``subtract=False`` in
  the flux + lift) against the JAX generic RHS;
- 10 LSRK54 steps through ``ExplicitSolverType().make`` (the var-major
  RHS: "auto" takes it for the Rusanov flux) and
  ``ExplicitSolverType(state_layout="grid")``, and "auto" choosing the
  generic operator for Roe and HLLC;
- ``weightedsum``, ``norm``, ``dot`` and ``euclidean_distance``.

The RHS and the steps start from the exact state times 1 + 1e-3·N(0, 1)
(numpy, seed 12): the exact state is continuous across faces, where the
three fluxes agree.  Every comparison is per variable, relative to the
JAX result's largest magnitude of that variable, within 1e-11; the
momentum's three components share the scale of the largest (ρw's
tendency is round-off about zero, ~4e-8 against ~2e6 for ρu).  The JAX references are jitted:
the three fluxes' RHS as one function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from climatemachine_tpu.atmos.numerical_fluxes import (
    HLLCNumericalFlux as JaxHLLC, RoeNumericalFlux as JaxRoe)
from climatemachine_tpu.dg import reductions as jax_reductions
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu.ode.lsrk import \
    LSRK54CarpenterKennedy as JaxLSRK54
from climatemachine_tpu_torch.dg import reductions
from climatemachine_tpu_torch.dg.fast_rhs import (SURFACE_KERNELS,
                                                  VarMajorRHS, supports)
from climatemachine_tpu_torch.dg.numerical_fluxes import (
    HLLCNumericalFlux, RoeNumericalFlux)
from climatemachine_tpu_torch.dg.spatial import DGModel
from climatemachine_tpu_torch.driver.solver_types import ExplicitSolverType
from climatemachine_tpu_torch.interop import (grid_to_numpy, state_from_numpy,
                                              to_node_major)
from climatemachine_tpu_torch.mesh.grid import min_node_distance
from test_isentropic_vortex import _setup as jax_setup
from vortex_parity import setup

TOL = 1e-11
FLUXES = {"rusanov": (None, None), "roe": (RoeNumericalFlux(), JaxRoe()),
          "hllc": (HLLCNumericalFlux(), JaxHLLC())}
N_STEPS = 10


def _rel_err(got, ref):
    """max|got − ref| of each variable of node-major ``[E, Np, 5]`` arrays
    over max|ref| of it, the momentum's components over the largest."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.max(np.abs(ref), axis=(0, 1))
    scale[1:4] = scale[1:4].max()
    return np.max(np.abs(got - ref), axis=(0, 1)) / scale


@pytest.fixture(scope="module")
def vortex():
    """Both packages' vortex at ne = 4, p4, the perturbed state, the JAX
    RHS of each flux there, and the JAX state after N_STEPS LSRK54 steps
    from it."""
    model_j, grid_j, dg_j, q0_j, aux_j = jax_setup(4, 4)
    q0_j = np.asarray(q0_j)
    rng = np.random.default_rng(12)
    qp_j = q0_j * (1 + 1e-3 * rng.standard_normal(q0_j.shape))
    dgs = {name: JaxDGModel(model_j, grid_j, numerical_flux_first_order=nf)
           for name, (_, nf) in FLUXES.items()}
    rhs_j = jax.jit(lambda q, a: {k: d(q, a, 0.0)[0]
                                  for k, d in dgs.items()})(qp_j, aux_j)
    dt = 0.4 * float(jax_min_node_distance(grid_j)) / 400.0
    step = JaxLSRK54(jax.jit(lambda q, a, t: dg_j(q, a, t)), dt)
    q, aux = jnp.asarray(qp_j), aux_j
    for i in range(N_STEPS):
        q, aux = step.step(q, aux, i * dt)
    model, grid, dg, q0, aux0 = setup(4, 4)
    return dict(model_j=model_j, grid_j=grid_j, q0_j=q0_j, qp_j=qp_j,
                aux_j=np.asarray(aux_j), dt=dt,
                rhs_j={k: np.asarray(v) for k, v in rhs_j.items()},
                q_steps_j=np.asarray(q), model=model, grid=grid, dg=dg,
                q0=q0, aux0=aux0)


def _port_state(v):
    """The perturbed state and the JAX initial aux as the port's
    var-major tensors."""
    return state_from_numpy(v["qp_j"], v["aux_j"], device="cpu",
                            model=v["model"])


def test_brick_grid_matches_jax(vortex):
    """make_grid on the periodic brick: every field the port reads, the
    periodic faces joined to the opposite side, no stack."""
    got, ref = grid_to_numpy(vortex["grid"]), vortex["grid_j"]
    for name in ("coords", "M", "MI", "J", "xi_x", "normals", "sM", "lift",
                 "Wdiv", "Wgrad"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(got[name], r, rtol=0,
                                   atol=1e-13 * np.abs(r).max(), err_msg=name)
    for name in ("face_bctag", "face_nbr_row", "fmask_padded"):
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(ref, name)))
    assert (got["face_bctag"] == 0).all()
    assert got["face_perm_identity"] and ref.face_perm_identity
    assert got["n_horz"] is None and got["n_vert"] is None
    for direction in ("every", "horizontal", "vertical"):
        assert min_node_distance(vortex["grid"], direction) == pytest.approx(
            float(jax_min_node_distance(vortex["grid_j"], direction)),
            rel=1e-14)


def test_init_state_matches_jax(vortex):
    """The port's exact solution and aux (coords, Φ = 0, ∇Φ = 0, the dry
    moisture lanes; no reference-state lanes) against the JAX ones."""
    m, mj = vortex["model"], vortex["model_j"]
    names = list(m.aux_spec.flattened_names())
    assert names == list(mj.aux_spec.flattened_names())
    assert not any(n.startswith("ref_state") for n in names)
    q0, aux0 = (to_node_major(t) for t in (vortex["q0"], vortex["aux0"]))
    assert _rel_err(q0, vortex["q0_j"]).max() < TOL
    ref = vortex["aux_j"]
    scale = np.maximum(np.max(np.abs(ref), axis=(0, 1)), 1e-300)
    assert (np.max(np.abs(aux0 - ref), axis=(0, 1)) / scale).max() < TOL


@pytest.mark.parametrize("flux", list(FLUXES))
def test_generic_rhs_matches_jax(vortex, flux):
    """The generic DG operator on the JAX state: the dry volume kernel's
    plain version with subtract_ref=False, the numerical flux on the
    node-gather pass (Roe, HLLC) or the var-major surface pass
    (Rusanov)."""
    dg = DGModel(vortex["model"], vortex["grid"],
                 numerical_flux_first_order=FLUXES[flux][0])
    assert dg.fast_surface == (flux == "rusanov")
    q, aux = _port_state(vortex)
    got = to_node_major(dg(q, aux, 0.0)[0])
    err = _rel_err(got, vortex["rhs_j"][flux])
    assert err.max() < TOL, err


def test_fluxes_differ(vortex):
    """The three fluxes give three RHS on the perturbed state."""
    r = vortex["rhs_j"]
    for a, b in (("rusanov", "roe"), ("rusanov", "hllc"), ("roe", "hllc")):
        assert _rel_err(r[a], r[b]).max() > 1e-9


@pytest.mark.parametrize("mode", SURFACE_KERNELS)
def test_var_major_rhs_matches_jax(vortex, mode):
    """VarMajorRHS on the vortex (na = 0: no reference pressure in the
    bundle) under each surface pass against the JAX generic RHS."""
    assert supports(vortex["dg"])
    rhs = VarMajorRHS(vortex["dg"])
    assert rhs.i_pref is None and not rhs.subtract
    rhs.surface_kernel = mode
    q, aux = _port_state(vortex)
    got = to_node_major(rhs(q, aux, 0.0)[0])
    err = _rel_err(got, vortex["rhs_j"]["rusanov"])
    assert err.max() < TOL, err


@pytest.mark.parametrize("layout", ["auto", "grid"])
def test_steps_match_jax(vortex, layout):
    """N_STEPS LSRK54 steps at the JAX test's dt, 0.4 min_node_distance /
    400, through ExplicitSolverType: "auto" on the var-major RHS, "grid"
    on the generic operator."""
    q, aux = _port_state(vortex)
    solver = ExplicitSolverType(state_layout=layout).make(
        vortex["dg"], q, aux, vortex["dt"])
    assert (solver.vm is None) == (layout == "grid")
    for i in range(N_STEPS):
        q, aux = solver.step(q, aux, i * vortex["dt"])
    err = _rel_err(to_node_major(q), vortex["q_steps_j"])
    assert err.max() < TOL, err


@pytest.mark.parametrize("flux", ["roe", "hllc"])
def test_auto_takes_the_generic_operator(vortex, flux):
    """"auto" chooses from the configuration: the var-major RHS computes
    the Rusanov flux only, so Roe and HLLC take the generic operator;
    "vm" raises for them."""
    dg = DGModel(vortex["model"], vortex["grid"],
                 numerical_flux_first_order=FLUXES[flux][0])
    assert not supports(dg)
    q, aux = vortex["q0"], vortex["aux0"]
    assert ExplicitSolverType().make(dg, q, aux, 1e-7).vm is None
    with pytest.raises(ValueError, match="var-major"):
        ExplicitSolverType(state_layout="vm").make(dg, q, aux, 1e-7)
    with pytest.raises(ValueError, match="Rusanov"):
        VarMajorRHS(dg)


def test_reductions_match_jax(vortex):
    """weightedsum of each field and of all, norm, dot and
    euclidean_distance, weighted and not."""
    g, gj = vortex["grid"], vortex["grid_j"]
    q, _ = _port_state(vortex)
    qj = jnp.asarray(vortex["qp_j"])
    b, bj = 0.5 * q + 1.0, 0.5 * qj + 1.0
    np.testing.assert_allclose(reductions.weightedsum(g, q).numpy(),
                               np.asarray(jax_reductions.weightedsum(gj, qj)),
                               rtol=1e-13)
    for field in range(5):
        assert float(reductions.weightedsum(g, q, field)) == pytest.approx(
            float(jax_reductions.weightedsum(gj, qj, field)), rel=1e-13)
    for w in (True, False):
        for name, args, jargs in (("norm", (q,), (qj,)),
                                  ("dot", (q, b), (qj, bj)),
                                  ("euclidean_distance", (q, b), (qj, bj))):
            got = float(getattr(reductions, name)(g, *args, weighted=w))
            ref = float(getattr(jax_reductions, name)(gj, *jargs,
                                                      weighted=w))
            assert got == pytest.approx(ref, rel=1e-13), (name, w)
