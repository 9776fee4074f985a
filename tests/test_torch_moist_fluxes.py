"""The port's first-order numerical fluxes on the moist, tracer-carrying
atmosphere against the JAX package's, in float64 on the CPU, on the
moist baroclinic wave with two tracers and warm rain at n_horz=2,
n_vert=2, p3 (tests/tracer_parity.py, nq = 9):

- each flux (Rusanov, Roe, ``RoeNumericalFluxMoist`` with and without
  the low-Mach scaling, HLLC, LMARS) on face states: the seeded test
  state's nodes as the minus side, the same perturbed by 1e-2 (every
  lane, so the advected scalars jump) as the plus side, both with the
  aux the JAX saturation adjustment refreshes, on random unit normals;
  per lane RHS_TOL of its largest magnitude, the generic RHS's precedent
  (the moist Roe's 6 × 6 solve amplifies the round-off of its Roe
  state's saturation adjustment to 5.5e-12 on ρe, the others stay under
  6e-13);
- the generic RHS ``DGModel(model, grid, numerical_flux_first_order=
  ...)`` with each flux but Rusanov, the default, whose RHS
  tests/test_torch_tracers.py holds, per variable RHS_TOL;
- Roe on the linear acoustic-gravity model of the moist atmosphere
  raises in both packages (its advected scalars would get the central
  flux alone).

The JAX face fluxes and the JAX RHS are computed by one jitted
function.
"""

import jax
import numpy as np
import pytest
import torch

import tracer_parity as tp

from climatemachine_tpu.atmos import numerical_fluxes as jax_nf
from climatemachine_tpu.atmos.linear import \
    AtmosAcousticGravityLinearModel as JaxLinear
from climatemachine_tpu.dg.numerical_fluxes import \
    RusanovNumericalFlux as JaxRusanov
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu_torch.atmos.linear import \
    AtmosAcousticGravityLinearModel
from climatemachine_tpu_torch.dg import numerical_fluxes as nf
from climatemachine_tpu_torch.dg.spatial import DGModel

#: name -> (the JAX flux, the port's), each built with the same arguments
FLUXES = {
    "rusanov": (JaxRusanov, nf.RusanovNumericalFlux, {}),
    "roe": (jax_nf.RoeNumericalFlux, nf.RoeNumericalFlux, {}),
    "roe_moist": (jax_nf.RoeNumericalFluxMoist, nf.RoeNumericalFluxMoist,
                  {}),
    "roe_moist_lm": (jax_nf.RoeNumericalFluxMoist,
                     nf.RoeNumericalFluxMoist, {"LM": True}),
    "hllc": (jax_nf.HLLCNumericalFlux, nf.HLLCNumericalFlux, {}),
    "lmars": (jax_nf.LMARSNumericalFlux, nf.LMARSNumericalFlux, {}),
}
#: the fluxes held in one RHS (the low-Mach variant only on faces)
RHS_FLUXES = ["roe", "roe_moist", "hllc", "lmars"]


def _vm(a):
    """Node-major ``[E, X, n]`` → var-major ``[E, n, X]`` tensor."""
    return torch.tensor(np.asarray(a)).transpose(1, 2).contiguous()


@pytest.fixture(scope="module")
def s():
    """tracer_parity.setup(), the face states (minus: the test state;
    plus: perturbed by 1e-2; aux of each from the JAX saturation
    adjustment) and normals, and the JAX references: each flux on the
    faces, each RHS at the test state."""
    out = tp.setup()
    mj, dg_j = out["model_j"], out["dg_j"]
    rng = np.random.default_rng(29)
    qM = out["q"]
    qP = qM * (1 + 1e-2 * rng.standard_normal(qM.shape))
    nrm = rng.standard_normal(qM.shape[:2] + (3,))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    dgs = {name: JaxDGModel(mj, dg_j.grid,
                            numerical_flux_first_order=FLUXES[name][0]())
           for name in RHS_FLUXES}

    def refs(qM, qP, aux0, nrm):
        auxM = mj.update_auxiliary_state(dg_j.grid, qM, aux0, 0.0)
        auxP = mj.update_auxiliary_state(dg_j.grid, qP, aux0, 0.0)
        faces = {name: jf(**kw)(mj, nrm, qM, auxM, qP, auxP, 0.0)
                 for name, (jf, _, kw) in FLUXES.items()}
        rhs = {name: d(qM, aux0, 0.0)[0] for name, d in dgs.items()}
        return dict(auxM=auxM, auxP=auxP, faces=faces, rhs=rhs)

    ref = jax.jit(refs)(*map(tp.as_jax, (qM, qP, out["aux0"], nrm)))
    out.update(qP=qP, nrm=nrm,
               ref=jax.tree_util.tree_map(np.asarray, ref))
    return out


@pytest.mark.parametrize("name", list(FLUXES))
def test_flux_on_face_states_matches_jax(s, name):
    _, flux, kw = FLUXES[name]
    r = s["ref"]
    got = flux(**kw)(s["model_t"], _vm(s["nrm"]), _vm(s["q"]), _vm(r["auxM"]),
                     _vm(s["qP"]), _vm(r["auxP"]), 0.0)
    want = _vm(r["faces"][name]).numpy()
    assert got.shape == want.shape and want.shape[1] == 9
    err = (np.abs(got.numpy() - want).max(axis=(0, 2))
           / np.abs(want).max(axis=(0, 2)))
    assert err.max() < tp.RHS_TOL, err


@pytest.mark.parametrize("name", RHS_FLUXES)
def test_rhs_with_flux_matches_jax(s, name):
    _, flux, kw = FLUXES[name]
    dg = DGModel(s["model_t"], s["dg_t"].grid,
                 numerical_flux_first_order=flux(**kw))
    assert not dg.fast_surface
    qt, auxt = tp.port_state(s)
    dq, _ = dg(qt, auxt, 0.0)
    err = tp.rel_err_per_var(dq, s["ref"]["rhs"][name])
    assert err.max() < tp.RHS_TOL, err


def test_roe_on_moist_linear_model_raises(s):
    r = s["ref"]
    lin_t = AtmosAcousticGravityLinearModel(s["model_t"])
    with pytest.raises(NotImplementedError, match="DryModel"):
        nf.RoeNumericalFlux()(lin_t, _vm(s["nrm"]), _vm(s["q"]),
                              _vm(r["auxM"]), _vm(s["qP"]), _vm(r["auxP"]),
                              0.0)
    with pytest.raises(NotImplementedError, match="DryModel"):
        jax_nf.RoeNumericalFlux()(JaxLinear(s["model_j"]), s["nrm"],
                                  s["q"], r["auxM"], s["qP"], r["auxP"], 0.0)
