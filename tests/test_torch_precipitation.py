"""The port's precipitation models and microphysics sources against the
JAX package, in float64 on the CPU, on the moist baroclinic wave with two
tracers at n_horz=2, n_vert=2, p3 (tests/tracer_parity.py) with each
precipitation set-up: ``RainModel`` + ``WarmRain1M`` ("warm_rain"), no
precipitation model + ``RemovePrecipitation`` ("remove"), and
``RainSnowModel`` + ``RainSnow1M`` ("rain_snow"), from the seeded test
state (supersaturated on a third of the nodes, rain and snow there, cold
enough aloft for ice and the freezing branches):

- the source's contributions, lane by lane, at the state and the aux the
  saturation adjustment refreshes, 1e-12 of each one's largest
  magnitude;
- the first-order flux with the precipitation's sedimentation, per
  variable 1e-12;
- the generic RHS of "remove" and "rain_snow" (the one of "warm_rain" is
  in tests/test_torch_tracers.py) per variable, RHS_TOL, the generic
  RHS's precedent;
- the terminal velocities on negative, zero and positive q;
- which operator takes a microphysics source, in both packages: never
  the var-major RHS ("vm" raises, "auto" gives the generic operator),
  and on a dry model the sources give nothing.

Each case's JAX references are computed by one jitted function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_parity as tp

from climatemachine_tpu.atmos import precipitation as jax_precip
from climatemachine_tpu.atmos.model import AtmosModel as JaxAtmosModel
from climatemachine_tpu.dg import fast_rhs as jax_fast_rhs
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.experiments.baroclinic_wave import \
    baroclinic_wave_config as jax_baroclinic_wave_config
from climatemachine_tpu_torch.atmos import precipitation
from climatemachine_tpu_torch.atmos.model import AtmosModel
from climatemachine_tpu_torch.dg import fast_rhs
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.driver.solver_types import ExplicitSolverType
from climatemachine_tpu_torch.experiments.baroclinic_wave import \
    baroclinic_wave_config

CASES = {"warm_rain": tp.WARM_RAIN,
         "remove": (None, "RemovePrecipitation"),
         "rain_snow": ("RainSnowModel", "RainSnow1M")}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """tracer_parity.setup() of the case, and the JAX references at the
    test state: the refreshed aux, the source's contributions and the
    first-order flux there, and (but for "warm_rain") the RHS."""
    s = tp.setup(CASES[request.param])
    mj, dg_j = s["model_j"], s["dg_j"]
    src = mj.sources[-1]

    def refs(q, aux0):
        aux = mj.update_auxiliary_state(dg_j.grid, q, aux0, 0.0)
        out = dict(aux=aux, F=mj.flux_first_order(q, aux, 0.0),
                   src=src.contributions(mj, q, None, aux, 0.0))
        if request.param != "warm_rain":
            out["dq"] = dg_j(q, aux0, 0.0)[0]
        return out

    s["ref"] = jax.tree_util.tree_map(
        np.asarray, jax.jit(refs)(tp.as_jax(s["q"]), s["aux0"]))
    return s


def test_source_contributions_match_jax(case):
    mt = case["model_t"]
    qt, auxt = tp.port_state(case)
    aux = mt.update_auxiliary_state(qt, auxt, case["dg_t"].grid)
    got = mt.sources[-1].contributions(mt, qt, None, aux, 0.0)
    want = case["ref"]["src"]
    assert set(got) == set(want) and len(got) >= 3
    for name, val in got.items():
        ref = want[name]
        scale = np.abs(ref).max()
        assert scale > 0, name
        err = np.abs(val.numpy() - ref).max() / scale
        assert err < 1e-12, (name, err)


def test_flux_matches_jax(case):
    mt = case["model_t"]
    qt, auxt = tp.port_state(case)
    aux = mt.update_auxiliary_state(qt, auxt, case["dg_t"].grid)
    F = mt.flux_first_order(qt, aux, 0.0)                 # [E, 3, n, Np]
    ref = case["ref"]["F"].transpose(0, 2, 3, 1)          # [E, 3, n, Np]
    err = (np.abs(F.numpy() - ref).max(axis=(0, 1, 3))
           / np.maximum(np.abs(ref).max(axis=(0, 1, 3)), 1e-300))
    assert err.max() < 1e-12, err


@pytest.mark.parametrize("case", ["remove", "rain_snow"], indirect=True)
def test_generic_rhs_matches_jax(case):
    qt, auxt = tp.port_state(case)
    dq, _ = case["dg_t"](qt, auxt, 0.0)
    err = tp.rel_err_per_var(dq, case["ref"]["dq"])
    assert err.max() < tp.RHS_TOL, err


@pytest.mark.parametrize("model, method", [
    ("RainModel", "terminal_velocity"),
    ("RainSnowModel", "terminal_velocity_rain"),
    ("RainSnowModel", "terminal_velocity_snow")])
def test_terminal_velocity_matches_jax(model, method):
    q = np.array([-1e-3, 0.0, 1e-8, 1e-5, 2e-3, 0.03])
    got = getattr(getattr(precipitation, model)(), method)(torch.tensor(q))
    want = getattr(getattr(jax_precip, model)(), method)(jnp.asarray(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14,
                               atol=0)
    assert got[0] == 0 and got[1] == 0


def test_microphysics_routes_like_jax():
    """The moist wave (no tracers) with RemovePrecipitation: neither
    package's var-major RHS takes the source, so "auto" gives the generic
    operator and "vm" raises; without it, both take the var-major RHS.
    On a dry model every microphysics source gives nothing."""
    size = tp.SIZE
    cfg_j = jax_baroclinic_wave_config(dtype=np.float64, **size)
    cfg_t = baroclinic_wave_config(dtype=torch.float64, device="cpu", **size)
    assert jax_fast_rhs.supports(JaxDGModel(cfg_j.model, cfg_j.grid))
    assert fast_rhs.supports(DGModel(cfg_t.model, cfg_t.grid))
    mj = JaxAtmosModel(cfg_j.model.physics, cfg_j.model.problem,
                       cfg_j.model.sources
                       + (jax_precip.RemovePrecipitation(),))
    mt = AtmosModel(cfg_t.model.physics, cfg_t.model.problem,
                    cfg_t.model.sources
                    + (precipitation.RemovePrecipitation(),))
    dg_t = DGModel(mt, cfg_t.grid)
    assert not jax_fast_rhs.supports(JaxDGModel(mj, cfg_j.grid))
    assert not fast_rhs.supports(dg_t)
    q0 = torch.ones((cfg_t.grid.nelem, 6, cfg_t.grid.Np), dtype=torch.float64)
    aux0 = torch.zeros((cfg_t.grid.nelem, mt.aux_spec.num, cfg_t.grid.Np),
                       dtype=torch.float64)
    assert ExplicitSolverType().make(dg_t, q0, aux0, 1.0).vm is None
    with pytest.raises(ValueError, match="var-major RHS"):
        ExplicitSolverType(state_layout="vm").make(dg_t, q0, aux0, 1.0)

    dry_t = baroclinic_wave_config(dtype=torch.float64, device="cpu",
                                   moist=False, **size)
    dry_j = jax_baroclinic_wave_config(dtype=np.float64, moist=False, **size)
    q, aux = init_ode_state(DGModel(dry_t.model, dry_t.grid))
    ctx = dry_t.model.source_context(q, aux)
    assert ctx.pp is None
    for name in ("RemovePrecipitation", "WarmRain1M", "RainSnow1M"):
        src = getattr(precipitation, name)()
        assert not src.on_var_major_rhs
        assert src.contributions_vm(dry_t.model, ctx, 0.0) == {}
        assert getattr(jax_precip, name)().contributions(
            dry_j.model, jnp.zeros((1, 1, 5)), None,
            jnp.zeros((1, 1, dry_j.model.aux_spec.num)), 0.0) == {}
