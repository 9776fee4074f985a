"""The shallow-water and barotropic models in the port against the JAX
package's, in float64 on the CPU (tests/split_explicit_parity.py: the
3 × 2 2-D brick at p3 over 1e6 × 1e6, walled or periodic), from a noisy
state about rest (numpy seeds):

- the generic ``DGModel`` RHS (central first-order flux) of
  ShallowWaterModel with ``ConstantViscosity`` (the gradient path, the
  free-slip reflection of ν∇U at SimpleBox's walls) and ``LinearDrag``,
  ``advection`` None and "nonlinear", OceanGyre (no-slip walls, wind
  stress, β-plane) and SimpleBox (Rotating), walled and periodic, and of
  BarotropicModel (its source −f×U + Gᵁ), each within 1e-11 of the JAX
  result's largest magnitude per variable;
- the Rusanov flux at wave speed c on the same faces;
- 3 LSRK54 steps of the walled gyre, within 1e-10;
- the lane names carried across by interop.py, the 2-D face normals
  and fluxes of two components.
"""

import jax
import pytest
import torch

from climatemachine_tpu.dg.numerical_fluxes import \
    RusanovNumericalFlux as JaxRusanov
from climatemachine_tpu.ode import lsrk as jlsrk
from climatemachine_tpu_torch.dg.numerical_fluxes import RusanovNumericalFlux
from climatemachine_tpu_torch.interop import state_from_numpy
from climatemachine_tpu_torch.ode import lsrk
from ocean_parity import nm, rel_err_per_var
from split_explicit_parity import sw_pair

TOL = 1e-11
STEP_TOL = 1e-10
DT = 300.0

CASES = {
    "visc_linear_walled_gyre": ("gyre", False, "visc", None, False),
    "visc_nonlinear_walled_gyre": ("gyre", False, "visc", "nonlinear", False),
    "visc_linear_walled_freeslip": ("simplebox", False, "visc", None, False),
    "visc_nonlinear_periodic": ("gyre", True, "visc", "nonlinear", False),
    "drag_linear_walled_gyre": ("gyre", False, "drag", None, False),
    "drag_nonlinear_periodic": ("simplebox", True, "drag", "nonlinear",
                                False),
    "barotropic_walled_gyre": ("gyre", False, "visc", None, True),
    "barotropic_periodic_freeslip": ("simplebox", True, "visc", None, True),
}


def pair(name, seed=0, **kw):
    case, periodic, turb, adv, baro = CASES[name]
    return sw_pair(case, periodic, baro, seed, turb, advection=adv, c=1.0,
                   **kw)


@pytest.fixture(scope="module", params=list(CASES))
def rhs_case(request):
    p = pair(request.param, seed=list(CASES).index(request.param))
    tj, aj = jax.jit(lambda q, a: p["dj"](q, a, 0.0))(p["qj"], p["aj"])
    tt, at = p["dg"](p["q"], p["aux"], 0.0)
    return dict(p, tj=tj, aj_out=aj, tt=tt, at=at, name=request.param)


def test_rhs(rhs_case):
    c = rhs_case
    assert max(rel_err_per_var(nm(c["tt"]), c["tj"])) < TOL
    assert max(rel_err_per_var(nm(c["at"]), c["aj_out"])) < TOL


def test_gradient_path(rhs_case):
    """ConstantViscosity takes the gradient path, LinearDrag does not."""
    c = rhs_case
    visc = CASES[c["name"]][2] == "visc"
    assert c["dg"].n_gradient == (2 if visc else 0)
    assert not c["dg"].dry_volume and not c["dg"].fast_surface


def test_rusanov_flux():
    """The Rusanov flux at c on the walled gyre's faces, ghosts included,
    against the JAX flux."""
    p = pair("visc_nonlinear_walled_gyre", seed=11,
             nf=(JaxRusanov, RusanovNumericalFlux))
    tj, _ = jax.jit(lambda q, a: p["dj"](q, a, 0.0))(p["qj"], p["aj"])
    tt, _ = p["dg"](p["q"], p["aux"], 0.0)
    assert max(rel_err_per_var(nm(tt), tj)) < TOL


def test_lsrk54_three_steps():
    p = pair("visc_nonlinear_walled_gyre", seed=5)
    rhs = jax.jit(lambda q, a, t: p["dj"](q, a, t))
    qj, aj = p["qj"], p["aj"]
    q, aux = p["q"], p["aux"]
    sj = jlsrk.LSRK54CarpenterKennedy(rhs, DT)
    st = lsrk.LSRK54CarpenterKennedy(p["dg"], DT)
    for i in range(3):
        qj, aj = sj.step(qj, aj, i * DT)
        q, aux = st.step(q, aux, i * DT)
    assert max(rel_err_per_var(nm(q), qj)) < STEP_TOL
    assert bool(torch.isfinite(q).all())


@pytest.mark.parametrize("barotropic", [False, True])
def test_lanes_carried_by_name(barotropic):
    """state_from_numpy checks the JAX lane names against the port's
    schema, shallow-water and barotropic."""
    p = pair("barotropic_walled_gyre" if barotropic
             else "visc_linear_walled_gyre")
    mj, mt = p["mj"], p["mt"]
    names = (mj.prog_spec.flattened_names(), mj.aux_spec.flattened_names())
    q, aux = state_from_numpy(p["qj"], p["aj"], device="cpu", model=mt,
                              names=names)
    assert torch.equal(q, p["q"]) and torch.equal(aux, p["aux"])
    assert list(mt.prog_spec.flattened_names()) == ["eta", "U[0]", "U[1]"]
    with pytest.raises(ValueError):
        state_from_numpy(p["qj"], p["aj"], device="cpu", model=mt,
                         names=(names[0][::-1], names[1]))


def test_two_component_fluxes():
    """On a 2-D grid the normals, the flux and the gradient carry two
    directions."""
    p = pair("visc_linear_walled_gyre")
    dg, q, aux = p["dg"], p["q"], p["aux"]
    ops = dg.face_operators("every")
    assert ops["nrm"].shape[1] == 2 and dg.grid.nface == 4
    assert p["mt"].flux_first_order(q, aux, 0.0).shape[1] == 2
    grad = dg.spatial_gradient(q, aux, 0.0)
    assert grad.shape == (dg.grid.nelem, 2, 2, dg.grid.Np)
    # the unit normals
    n = ops["nrm"]
    assert torch.allclose((n * n).sum(1), torch.ones_like(n[:, 0]))
