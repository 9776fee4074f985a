"""The port's LES diagnostics groups (diagnostics/atmos_les.py:
AtmosLESDefault, AtmosLESCore, AtmosLESDefaultPerturbations) against the
JAX package's, in float64 on the CPU, on the moist box of
tests/test_atmos_les_diagnostics.py (p3, 3 × 3 × 3 elements,
EquilMoist, ConstantKinematicViscosity(0.1)): with its saturated band
(cloudy) and with the band moved above the domain (cloud-free, where
cld_top and cld_base are NaN).  The box's state is horizontally
uniform apart from w, so its state and its temperature lane are
multiplied by 1 + 1e-3·N(0, 1) (seeded) to give every variance,
covariance and perturbation a value above round-off;
the JAX state and aux are carried over; each profile or scalar within
1e-11 of its largest |value|, NaN where JAX has NaN.
"""

import numpy as np
import pytest
import torch

import test_atmos_les_diagnostics as jles
from climatemachine_tpu.diagnostics import atmos_les as jax_les
from climatemachine_tpu.mesh.interpolation import \
    InterpolationBrick as JaxInterpolationBrick
from climatemachine_tpu_torch import driver_api as cm
from climatemachine_tpu_torch.diagnostics import atmos_les
from climatemachine_tpu_torch.interop import state_from_numpy
from climatemachine_tpu_torch.io.writers import NetCDFWriter, NpzWriter
from climatemachine_tpu_torch.mesh.interpolation import InterpolationBrick

TOL = 1e-11
GROUPS = ("AtmosLESDefaultGroup", "AtmosLESCoreGroup",
          "AtmosLESDefaultPerturbationsGroup")
PTS = np.linspace(50.0, 950.0, 5)


def _port_setup(dg_j, q_j, aux_j):
    """The port's model, DG operator and the JAX state on the same box."""
    r = [np.linspace(0, jles.L, 4)] * 2 + [np.linspace(0, jles.H, 4)]
    topo = cm.topology.stacked_brick_topology(
        r, periodicity=(True, True, False),
        boundary=np.array([[0, 0], [0, 0], [1, 2]]))
    grid = cm.make_grid(topo, 3, dtype=torch.float64, device="cpu")
    physics = cm.AtmosPhysics(
        ref_state=cm.HydrostaticState(cm.DryAdiabaticProfile(300.0, 110.0)),
        turbulence=cm.ConstantKinematicViscosity(0.1),
        moisture=cm.EquilMoist())
    model = cm.AtmosModel(physics, cm.AtmosProblem(
        boundary_conditions=(cm.AtmosBC(), cm.AtmosBC())))
    bl = dg_j.balance_law
    q, aux = state_from_numpy(
        np.asarray(q_j), np.asarray(aux_j), device="cpu", model=model,
        names=(bl.prog_spec.flattened_names(),
               bl.aux_spec.flattened_names()))
    return cm.DGModel(model, grid), q, aux


@pytest.fixture(scope="module", params=["cloudy", "clear"])
def boxes(request):
    mp = pytest.MonkeyPatch()
    if request.param == "clear":
        mp.setattr(jles, "CLD_LO", 2 * jles.H)
        mp.setattr(jles, "CLD_HI", 3 * jles.H)
    dg_j, q_j, aux_j = jles._setup()
    mp.undo()
    rng = np.random.default_rng(0)
    q_j = np.asarray(q_j) * (1 + 1e-3 * rng.standard_normal(np.shape(q_j)))
    aux_j = np.array(aux_j)
    lane = dg_j.balance_law.aux_spec.index("moisture.temperature").start
    aux_j[..., lane] *= 1 + 1e-3 * rng.standard_normal(aux_j.shape[:2])
    return request.param, (dg_j, q_j, aux_j), _port_setup(dg_j, q_j, aux_j)


def _groups(name, dg_j, dg):
    if name == "AtmosLESDefaultPerturbationsGroup":
        return (getattr(jax_les, name)(
                    dg_j, JaxInterpolationBrick(dg_j.grid, PTS, PTS, PTS)),
                getattr(atmos_les, name)(
                    dg, InterpolationBrick(dg.grid, PTS, PTS, PTS)))
    return getattr(jax_les, name)(dg_j), getattr(atmos_les, name)(dg)


@pytest.mark.parametrize("name", GROUPS)
def test_group_matches_jax(boxes, name):
    case, (dg_j, q_j, aux_j), (dg, q, aux) = boxes
    g_j, g = _groups(name, dg_j, dg)
    ref = g_j.collect(q_j, aux_j, 0.0)
    got = g.collect(q, aux, 0.0)
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        v = got[k]
        assert np.shape(v) == np.shape(r), k
        nan = np.isnan(r)
        assert np.array_equal(np.isnan(v), nan), k
        if nan.all():
            continue
        scale = max(np.max(np.abs(r[~nan])), 1e-300)
        assert np.max(np.abs(v[~nan] - r[~nan])) <= TOL * scale, k
    if name == "AtmosLESDefaultGroup":
        if case == "clear":
            assert np.isnan(got["cld_top"]) and np.isnan(got["cld_base"])
            assert got["lwp"] == 0.0
        else:
            assert got["lwp"] > 0.0 and got["cld_top"] > got["cld_base"]
        assert np.allclose(g.z_levels, g_j.z_levels, rtol=1e-14)


def test_profiles_written(boxes, tmp_path):
    """The group's write through both writers: the profiles on a ``z``
    dimension, the scalars alone."""
    _, _, (dg, q, aux) = boxes
    h5py = pytest.importorskip("h5py")
    nc = atmos_les.AtmosLESDefaultGroup(dg, writer=NetCDFWriter(),
                                        out_path=str(tmp_path / "p.nc"))
    npz = atmos_les.AtmosLESDefaultGroup(dg, writer=NpzWriter(),
                                         out_path=str(tmp_path / "p.npz"))
    for t in (0.0, 1.0):
        vals = nc.write(q, aux, t)
        npz.write(q, aux, t)
    nlev = dg.grid.n_vert * dg.grid.Nq[2]
    with h5py.File(tmp_path / "p.nc") as f:
        assert f["u"].shape == (2, nlev) and f["lwp"].shape == (2,)
        assert np.array_equal(f["z"][:], nc.z_levels)
        assert np.array_equal(f["thl"][1], vals["thl"])
    last = np.load(tmp_path / "p_t1.000000e+00.npz")
    assert last["time"] == 1.0 and np.array_equal(last["thl"], vals["thl"])
    dims = np.load(tmp_path / "p.npz")
    assert list(dims["__dims__"]) == ["z"]
