"""The atmosphere model's defaults and reference-state options in the port
against the JAX package, in float64 on the CPU, on a small walled box (a
3 × 3 × 2 brick on [0, 2 km]² × [0, 1 km] at p3):

- ``AtmosPhysics()`` defaults to ``FlatOrientation`` and
  ``NoReferenceState`` in both packages: the same aux lanes in the same
  order (no reference-state lanes), the same aux, and the same RHS (the
  generic DG operator, and the var-major RHS under each surface pass)
  with ``Gravity`` (−ρ∇Φ: no reference density to take out);
- ``HydrostaticState(_subtract_off=False)``: the reference state's lanes
  in aux, nothing taken out of the momentum flux or the gravity source;
- ``NoOrientation``, ``FlatOrientation`` and ``SphericalOrientation``:
  Φ and ∇Φ;
- the walled box's grid built by the port's ``brick_topology`` and
  ``make_grid`` against the JAX package's (every side tagged 1).

The state is a smooth stratified flow built in numpy on the JAX grid's
nodes.  Per variable, relative to the JAX result's largest magnitude of
the variable (the momentum's components over the largest), within 1e-11.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.atmos import AtmosModel as JaxAtmosModel
from climatemachine_tpu.atmos import AtmosPhysics as JaxAtmosPhysics
from climatemachine_tpu.atmos.model import AtmosProblem as JaxAtmosProblem
from climatemachine_tpu.atmos.ref_state import \
    HydrostaticState as JaxHydrostaticState
from climatemachine_tpu.atmos.sources import Gravity as JaxGravity
from climatemachine_tpu.common import orientations as jax_orientations
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init_ode_state
from climatemachine_tpu.mesh.grid import make_grid as jax_make_grid
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu.mesh.topology import \
    brick_topology as jax_brick_topology
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.ref_state import (HydrostaticState,
                                                      NoReferenceState)
from climatemachine_tpu_torch.atmos.sources import Gravity
from climatemachine_tpu_torch.common import orientations
from climatemachine_tpu_torch.dg.fast_rhs import SURFACE_KERNELS, VarMajorRHS
from climatemachine_tpu_torch.dg.spatial import (DGModel,
                                                 init_state_auxiliary)
from climatemachine_tpu_torch.interop import (grid_to_numpy,
                                              state_from_numpy,
                                              to_node_major)
from climatemachine_tpu_torch.mesh.grid import make_grid, min_node_distance
from climatemachine_tpu_torch.mesh.topology import brick_topology
from climatemachine_tpu_torch.physics.parameters import EARTH

TOL = 1e-11
RANGES = [np.linspace(0.0, 2000.0, 4), np.linspace(0.0, 2000.0, 4),
          np.linspace(0.0, 1000.0, 3)]


def _rel_err(got, ref):
    """max|got − ref| per variable of node-major arrays over max|ref| of it,
    the momentum's components over the largest."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.max(np.abs(ref), axis=(0, 1))
    scale[1:4] = scale[1:4].max()
    return np.max(np.abs(got - ref), axis=(0, 1)) / scale


def _flow(coords):
    """A smooth stratified flow ``[E, Np, 5]`` at node-major coords."""
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    ps = EARTH
    rho = 1.2 * np.exp(-z / 8000.0) * (1 + 0.01 * np.sin(np.pi * x / 1000))
    u = np.stack([10 + np.sin(np.pi * y / 1000),
                  5 * np.cos(np.pi * x / 1000),
                  0.1 * np.sin(np.pi * z / 500)], axis=-1)
    T = 290.0 - 0.0065 * z
    e = ps.cv_d * (T - ps.T_0) + 0.5 * np.sum(u * u, axis=-1) + ps.grav * z
    return np.concatenate([rho[..., None], rho[..., None] * u,
                           (rho * e)[..., None]], axis=-1)


def _ref_states():
    """(port reference state, JAX reference state) by case."""
    return {"default": (None, None),
            "hydrostatic_no_subtract": (
                HydrostaticState(_subtract_off=False),
                JaxHydrostaticState(_subtract_off=False))}


@pytest.fixture(scope="module")
def box():
    grid_j = jax_make_grid(jax_brick_topology(RANGES), 3, dtype=np.float64)
    q = _flow(np.asarray(grid_j.coords))
    cases = {}
    for name, (rs, rs_j) in _ref_states().items():
        phys_j = (JaxAtmosPhysics() if rs_j is None
                  else JaxAtmosPhysics(ref_state=rs_j))
        model_j = JaxAtmosModel(phys_j, JaxAtmosProblem(
            init_state=lambda m, c, aux, t: jnp.asarray(q)),
            sources=(JaxGravity(),))
        dg_j = JaxDGModel(model_j, grid_j)
        _, aux_j = jax_init_ode_state(dg_j)
        rhs_j = jax.jit(lambda q, a: dg_j(q, a, 0.0)[0])(jnp.asarray(q),
                                                         aux_j)
        phys = AtmosPhysics() if rs is None else AtmosPhysics(ref_state=rs)
        model = AtmosModel(phys, AtmosProblem(), sources=(Gravity(),))
        cases[name] = dict(model=model, model_j=model_j,
                           aux_j=np.asarray(aux_j), rhs_j=np.asarray(rhs_j))
    grid = make_grid(brick_topology(RANGES), 3, dtype=torch.float64,
                     device="cpu")
    return dict(grid=grid, grid_j=grid_j, q=q, cases=cases)


def test_walled_brick_grid_matches_jax(box):
    """The port's brick with no side wrapping: every field the port
    reads against the JAX grid, each side a wall with tag 1."""
    got, ref = grid_to_numpy(box["grid"]), box["grid_j"]
    for name in ("coords", "M", "MI", "J", "xi_x", "normals", "sM", "lift",
                 "Wdiv", "Wgrad"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(got[name], r, rtol=0,
                                   atol=1e-13 * np.abs(r).max(), err_msg=name)
    for name in ("face_bctag", "face_nbr_row", "fmask_padded"):
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(ref, name)))
    assert set(np.unique(got["face_bctag"])) == {0, 1}
    assert got["n_horz"] is None and got["n_vert"] is None
    for direction in ("every", "horizontal", "vertical"):
        assert min_node_distance(box["grid"], direction) == pytest.approx(
            float(jax_min_node_distance(box["grid_j"], direction)),
            rel=1e-14)


def test_defaults_are_the_jax_packages():
    ph, ph_j = AtmosPhysics(), JaxAtmosPhysics()
    assert type(ph.orientation).__name__ == type(ph_j.orientation).__name__ \
        == "FlatOrientation"
    assert type(ph.ref_state).__name__ == type(ph_j.ref_state).__name__ \
        == "NoReferenceState"
    assert isinstance(ph.ref_state, NoReferenceState)
    assert not ph.ref_state.subtract_off
    assert HydrostaticState().subtract_off
    assert not HydrostaticState(_subtract_off=False).subtract_off


@pytest.mark.parametrize("case", list(_ref_states()))
def test_aux_matches_jax(box, case):
    """The aux lanes, by name and order, and their values."""
    c = box["cases"][case]
    names = list(c["model"].aux_spec.flattened_names())
    assert names == list(c["model_j"].aux_spec.flattened_names())
    assert any(n.startswith("ref_state") for n in names) == (
        case != "default")
    q, _ = state_from_numpy(box["q"], c["aux_j"], device="cpu")
    aux = c["model"].update_auxiliary_state(
        q, init_state_auxiliary(c["model"], box["grid"]), box["grid"])
    ref = c["aux_j"]
    scale = np.maximum(np.max(np.abs(ref), axis=(0, 1)), 1e-300)
    err = np.max(np.abs(to_node_major(aux) - ref), axis=(0, 1)) / scale
    assert err.max() < TOL, dict(zip(names, err))


@pytest.mark.parametrize("case", list(_ref_states()))
def test_rhs_matches_jax(box, case):
    """The generic DG operator and the var-major RHS (each surface pass)
    against the JAX DGModel, with Gravity, walls on every side."""
    c = box["cases"][case]
    q, aux = state_from_numpy(box["q"], c["aux_j"], device="cpu",
                              model=c["model"])
    dg = DGModel(c["model"], box["grid"])
    err = _rel_err(to_node_major(dg(q, aux, 0.0)[0]), c["rhs_j"])
    assert err.max() < TOL, err
    rhs = VarMajorRHS(dg)
    assert not rhs.subtract and rhs.i_pref is None
    for mode in SURFACE_KERNELS:
        rhs.surface_kernel = mode
        err = _rel_err(to_node_major(rhs(q, aux, 0.0)[0]), c["rhs_j"])
        assert err.max() < TOL, (mode, err)


@pytest.mark.parametrize("name", ["NoOrientation", "FlatOrientation",
                                  "SphericalOrientation"])
def test_orientations_match_jax(name):
    rng = np.random.default_rng(3)
    coords = 6.4e6 + 1e5 * rng.standard_normal((4, 27, 3))
    ori, ori_j = getattr(orientations, name)(), \
        getattr(jax_orientations, name)()
    assert ori.vars_aux().num == ori_j.vars_aux().num == 4
    c = torch.as_tensor(coords).transpose(1, 2)       # [E, 3, Np]
    np.testing.assert_allclose(
        ori.geopotential(EARTH, c).numpy(),
        np.asarray(ori_j.geopotential(EARTH, jnp.asarray(coords))),
        rtol=1e-14, atol=0)
    np.testing.assert_allclose(
        ori.grad_geopotential(EARTH, c).transpose(1, 2).numpy(),
        np.asarray(ori_j.grad_geopotential(EARTH, jnp.asarray(coords))),
        rtol=1e-14, atol=0)
