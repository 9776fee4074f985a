"""The port's GCM diagnostics (diagnostics/fields.py, groups_extra.py)
against the JAX package's, in float64 on the CPU, on Held-Suarez at
n_horz = 2, n_vert = 2, p3: the initial state with a seeded random
wind (ρu = ρ·10·N(0, 1), so that the vorticity and the spectra are not
zero) and ρ, ρe times 1 + 1e-3·N(0, 1), given to both packages (the
port's initial state: tests/test_torch_held_suarez.py holds it against
the JAX package's).  On a
lat-lon grid of Gauss-Legendre latitudes: AtmosGCMDefault (with vort
and vort2), AtmosMassEnergyLoss, AtmosTurbulenceStats,
AtmosRefStatePerturbations, AtmosGCMSpectra (1-D and spherical-harmonic)
and the state, aux and tendency dumps, each value within 1e-11 of its
largest |value|.  Also AtmosLESSpectra and the vorticity on the JAX
package's test flows.
"""

import numpy as np
import pytest
import torch

from climatemachine_tpu.common.spectra import gaussian_lats_deg
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.diagnostics import fields as jfields
from climatemachine_tpu.diagnostics import groups_extra as jextra
from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu.mesh.interpolation import \
    InterpolationCubedSphere as JaxInterpolationCubedSphere
from climatemachine_tpu_torch.diagnostics import fields, groups_extra
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.experiments.held_suarez import \
    held_suarez_config
from climatemachine_tpu_torch.interop import (state_from_numpy,
                                              state_to_numpy)
from climatemachine_tpu_torch.io.writers import NetCDFWriter
from climatemachine_tpu_torch.mesh.grid import make_grid
from climatemachine_tpu_torch.mesh.interpolation import (
    InterpolationBrick, InterpolationCubedSphere)
from climatemachine_tpu_torch.mesh.topology import stacked_brick_topology
from climatemachine_tpu_torch.physics.parameters import EARTH
from les_parity import port_model

TOL = 1e-11
LATS = gaussian_lats_deg(8)
LONS = np.linspace(-180.0, 157.5, 16)
RADS = EARTH.planet_radius + np.linspace(2e3, 28e3, 3)
L_BOX = 1000.0
BOUNDARY = np.array([[0, 0], [0, 0], [1, 2]])


@pytest.fixture(scope="module")
def gcm():
    cfg_j = jax_held_suarez_config(n_horz=2, n_vert=2, poly_order=3,
                                   dtype=np.float64)
    dg_j = JaxDGModel(cfg_j.model, cfg_j.grid)
    cfg = held_suarez_config(n_horz=2, n_vert=2, poly_order=3,
                             dtype=torch.float64, device="cpu")
    q_j, aux_j = state_to_numpy(*init_ode_state(DGModel(cfg.model,
                                                        cfg.grid)))
    rng = np.random.default_rng(0)
    rho = q_j[..., :1]
    q_j[..., 1:4] = rho * 10.0 * rng.standard_normal(q_j[..., 1:4].shape)
    q_j[..., (0, 4)] *= 1 + 1e-3 * rng.standard_normal(q_j[..., :2].shape)
    bl = cfg_j.model
    q, aux = state_from_numpy(q_j, aux_j, device="cpu", model=cfg.model,
                              names=(bl.prog_spec.flattened_names(),
                                     bl.aux_spec.flattened_names()))
    return dict(
        jax=(dg_j, q_j, aux_j,
             JaxInterpolationCubedSphere(cfg_j.grid, LATS, LONS, RADS)),
        port=(DGModel(cfg.model, cfg.grid), q, aux,
              InterpolationCubedSphere(cfg.grid, LATS, LONS, RADS)))


def _close(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        v = np.asarray(got[k])
        assert v.shape == r.shape, k
        scale = max(np.max(np.abs(r)), 1e-300)
        assert np.max(np.abs(v - r)) <= TOL * scale, (k, np.max(np.abs(
            v - r)) / scale)


GROUPS = {
    "AtmosGCMDefault": lambda m, dg, itp: m.AtmosGCMDefaultGroup(dg, itp),
    "AtmosRefStatePerturbations":
        lambda m, dg, itp: m.AtmosRefStatePerturbationsGroup(dg, itp),
    "DumpState": lambda m, dg, itp: m.DumpGroup(dg, "state"),
    "DumpAux": lambda m, dg, itp: m.DumpGroup(dg, "aux"),
    "DumpTendencies":
        lambda m, dg, itp: m.DumpGroup(dg, "tendencies", interpolator=itp),
}


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_group_matches_jax(gcm, name):
    dg_j, q_j, aux_j, itp_j = gcm["jax"]
    dg, q, aux, itp = gcm["port"]
    mod_j = jfields if name == "AtmosGCMDefault" else jextra
    mod = fields if name == "AtmosGCMDefault" else groups_extra
    ref = GROUPS[name](mod_j, dg_j, itp_j).collect(q_j, aux_j)
    got = GROUPS[name](mod, dg, itp).collect(q, aux)
    _close(got, ref)
    if name == "AtmosGCMDefault":
        assert np.max(np.abs(got["vort"])) > 0.0
        assert got["u"].shape == (len(LATS), len(LONS), len(RADS))


def test_spectra_matches_jax(gcm):
    dg_j, q_j, aux_j, itp_j = gcm["jax"]
    dg, q, aux, itp = gcm["port"]
    ref = jextra.AtmosGCMSpectraGroup(dg_j, itp_j).collect(q_j, aux_j)
    got = groups_extra.AtmosGCMSpectraGroup(dg, itp).collect(q, aux)
    assert "spectrum_2d" in got
    _close(got, ref)


def test_scalar_groups_match_jax(gcm):
    """Two writes each: the first sets the mass and energy reference and
    E_k; the second sees ρ and ρe times 1.01 and the momentum halved."""
    dg_j, q_j, aux_j, _ = gcm["jax"]
    dg, q, aux, _ = gcm["port"]
    q2_j = np.array(q_j)
    q2_j[..., (0, 4)] *= 1.01
    q2_j[..., 1:4] *= 0.5
    q2 = state_from_numpy(q2_j, aux_j, device="cpu")[0]
    for make_j, make in (
            (lambda: jextra.AtmosMassEnergyLossGroup(dg_j),
             lambda: groups_extra.AtmosMassEnergyLossGroup(dg)),
            (lambda: jextra.AtmosTurbulenceStatsGroup(dg_j, 10.0, 2.0),
             lambda: groups_extra.AtmosTurbulenceStatsGroup(dg, 10.0,
                                                            2.0))):
        g_j, g = make_j(), make()
        for qq_j, qq in ((q_j, q), (q2_j, q2)):
            ref = g_j.write(qq_j, aux_j, 0.0)
            got = g.write(qq, aux, 0.0)
            assert sorted(got) == sorted(ref)
            for k in ref:
                assert abs(float(got[k]) - float(ref[k])) <= TOL * max(
                    abs(float(ref[k])), 1e-300), k
    assert float(got["dE"]) > 0.0


def test_vorticity_of_shear_flow():
    """u = (sin(2πy/L), 0, 0) on a periodic box: ω_z = −2π/L cos(2πy/L)
    within the p4 DG error and ω_x = 0, as the JAX package's test asks."""
    g = make_grid(stacked_brick_topology(
        [np.linspace(0, L_BOX, 5)] * 2 + [np.linspace(0, L_BOX, 3)],
        (True, True, False), BOUNDARY), 4, dtype=torch.float64, device="cpu")
    y = g.coords[..., 1]
    u = torch.stack([torch.sin(2 * np.pi * y / L_BOX), 0 * y, 0 * y], dim=1)
    w = fields.vorticity(DGModel(port_model(), g), u)
    expect = -2 * np.pi / L_BOX * torch.cos(2 * np.pi * y / L_BOX)
    assert torch.max(torch.abs(w[:, 2] - expect)) < 5e-4
    assert torch.max(torch.abs(w[:, 0])) < 1e-8


def test_les_spectra():
    """The box spectrum of u = sin(2πx/L) (the JAX package's test): its
    energy in the k = 1 shell (the interpolation and power_spectrum_3d
    are held against the JAX package in tests/test_torch_interpolation.py)."""
    g = make_grid(stacked_brick_topology(
        [np.linspace(0, L_BOX, 4)] * 3, (True, True, False), BOUNDARY), 3,
        dtype=torch.float64, device="cpu")
    dg = DGModel(port_model(), g)
    q, _ = init_ode_state(dg)
    x = g.coords[..., 0]
    q[:, 1] = q[:, 0] * torch.sin(2 * np.pi * x / L_BOX)
    n = 16
    pts = np.linspace(0, L_BOX, n, endpoint=False)
    spec = groups_extra.AtmosLESSpectraGroup(
        dg, InterpolationBrick(g, pts, pts, pts + L_BOX / (2 * n)),
        L=L_BOX).collect(q)["spectrum"]
    assert spec.shape == (n // 2,)
    assert spec[0] > 100 * spec[1:].sum()


def test_groups_written(gcm, tmp_path):
    """The JAX test's file checks (tests/test_diagnostics_groups.py):
    each group written twice through the NetCDF writer, its variables on
    the time axis and their dimensions."""
    h5py = pytest.importorskip("h5py")
    dg, q, aux, itp = gcm["port"]
    g = dg.grid
    groups = {
        "mel": groups_extra.AtmosMassEnergyLossGroup(dg),
        "spec": groups_extra.AtmosGCMSpectraGroup(dg, itp),
        "state": groups_extra.DumpGroup(dg, "state"),
        "pert": groups_extra.AtmosRefStatePerturbationsGroup(dg, itp),
        "default": fields.AtmosGCMDefaultGroup(dg, itp)}
    for name, grp in groups.items():
        grp.writer, grp.out_path = NetCDFWriter(), str(tmp_path / name)
        for t in (0.0, 1.0):
            grp.write(q, aux, t)
    nk = len(LONS) // 2
    with h5py.File(tmp_path / "mel") as f:
        assert f["delta_mass"].shape == (2,) and f["delta_mass"][1] == 0.0
    with h5py.File(tmp_path / "spec") as f:
        assert f["spectrum_1d"].shape == (2, nk, len(RADS))
        assert f["spectrum_2d"].shape[::3] == (2, len(RADS))
    with h5py.File(tmp_path / "state") as f:
        assert f["rho"].shape == (2, g.nelem, g.Np)
        assert np.array_equal(f["rho"][1], q[:, 0].numpy())
    with h5py.File(tmp_path / "pert") as f:
        assert f["temp"].shape == (2, len(LATS), len(LONS), len(RADS))
        assert np.allclose(f["long"][:], LONS)
    with h5py.File(tmp_path / "default") as f:
        assert f["vort"].shape == (2, len(LATS), len(LONS), len(RADS))
