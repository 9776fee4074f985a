"""The port's output and checks (io/writers.py, io/vtk.py,
diagnostics/state_check.py, diagnostics/machine.py,
balance_laws/show_tendencies.py, utils/single_stack.py, utils/tictoc.py)
against the JAX package's, in float64 on the CPU:

- the NetCDF (h5py) and npz writers' round trips, and the NetCDF
  writer's ImportError without h5py;
- ``writevtk`` and ``vtk_dump_state`` parsed back (``readvtk``) against
  the JAX package's file of the same fields (coordinates and fields
  within 1e-9, the ascii's 10 digits; cells exactly), the JAX
  ``writevtk``'s text on the port's grid equal to the port's file,
  ``writepvtu``'s text equal;
- ``StateCheck``: statistics within 1e-12 of the JAX StateCheck's on the
  same array, ``do_check`` passing on an exact match and failing on a
  perturbed one, and the 30-step Held-Suarez p3 run (LSRK54 on the
  generic operator, tests/test_statecheck_refvals.py's case) against
  tests/refvals/held_suarez.py at that test's rtols (1e-6; momentum
  1e-4);
- ``horizontal_average``, the default-variable group and the
  single-stack profiles against JAX within 1e-12;
- ``show_tendencies``' text equal to the JAX package's for Held-Suarez,
  DYCOMS-II RF01 and BOMEX (the JAX source discovery given the gradient
  flux's own shape: as it stands it lists Subsidence and BomexTendencies
  nowhere, a reference caveat).
"""

import importlib.util
import logging
import pathlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.balance_laws import show_tendencies as jst
from climatemachine_tpu.diagnostics import machine as jmachine
from climatemachine_tpu.diagnostics.state_check import \
    StateCheck as JaxStateCheck
from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu.io import vtk as jvtk
from climatemachine_tpu.utils import single_stack as jss
from climatemachine_tpu_torch.diagnostics import machine
from climatemachine_tpu_torch.diagnostics.state_check import StateCheck
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.experiments import bomex_les, dycoms
from climatemachine_tpu_torch.experiments.held_suarez import \
    held_suarez_config
from climatemachine_tpu_torch.interop import state_to_numpy
from climatemachine_tpu_torch.io import vtk, writers
from climatemachine_tpu_torch.mesh.grid import min_node_distance
from climatemachine_tpu_torch.ode.lsrk import LSRK54CarpenterKennedy
from climatemachine_tpu_torch.ode.solve import solve
from climatemachine_tpu_torch.utils import single_stack, tictoc
from climatemachine_tpu_torch.utils.variables import VarSpec
import forced_les_parity as flp

REFVALS = pathlib.Path(__file__).resolve().parent / "refvals" / \
    "held_suarez.py"


def _refvals():
    spec = importlib.util.spec_from_file_location("hs_refvals", REFVALS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.refvals


@pytest.fixture(scope="module")
def hs():
    """Held-Suarez p3 at n_horz = n_vert = 2 in both packages, the
    port's initial state with a seeded wind and ρ, ρe times 1 +
    1e-3·N(0, 1), so that no horizontal variance is round-off alone."""
    cfg_j = jax_held_suarez_config(n_horz=2, n_vert=2, poly_order=3,
                                   dtype=np.float64)
    cfg = held_suarez_config(n_horz=2, n_vert=2, poly_order=3,
                             dtype=torch.float64, device="cpu")
    dg = DGModel(cfg.model, cfg.grid)
    q, aux = init_ode_state(dg)
    rng = np.random.default_rng(0)
    q[:, 1:4] = q[:, :1] * torch.tensor(rng.standard_normal(
        q[:, 1:4].shape))
    q[:, (0, 4)] *= 1 + 1e-3 * torch.tensor(rng.standard_normal(
        q[:, (0, 4)].shape))
    q_j, aux_j = state_to_numpy(q, aux)
    return cfg_j, cfg, dg, q, aux, q_j, aux_j


def test_netcdf_round_trip(tmp_path):
    h5py = pytest.importorskip("h5py")
    w = writers.NetCDFWriter()
    path = str(tmp_path / "diag.nc")
    w.init_data(path, {"z": np.linspace(0, 1, 5)},
                {"Tavg": (("z",), np.float64), "lwp": ((), np.float64)})
    w.append_data(path, {"Tavg": np.arange(5.0), "lwp": 1.5}, 0.0)
    w.append_data(path, {"Tavg": np.arange(5.0) + 1, "lwp": 2.5}, 10.0)
    with h5py.File(path) as f:
        assert list(f["time"][:]) == [0.0, 10.0]
        assert np.array_equal(f["Tavg"][1], np.arange(5.0) + 1)
        assert list(f["lwp"][:]) == [1.5, 2.5]
        assert f["Tavg"].dims[1][0].name.endswith("z")


def test_netcdf_needs_h5py(tmp_path, monkeypatch):
    import builtins
    real_import = builtins.__import__

    def no_h5py(name, *a, **kw):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="NpzWriter"):
        writers.NetCDFWriter().init_data(str(tmp_path / "x.nc"), {}, {})
    assert not (tmp_path / "x.nc").exists()


def test_npz_round_trip(tmp_path):
    w = writers.NpzWriter()
    path = str(tmp_path / "diag.npz")
    z = np.linspace(0, 1, 5)
    w.init_data(path, {"z": z}, {"Tavg": (("z",), np.float64)})
    w.append_data(path, {"Tavg": np.arange(5.0)}, 0.5)
    dims = np.load(path)
    assert list(dims["__dims__"]) == ["z"]
    assert np.array_equal(dims["dim_z"], z)
    rec = np.load(tmp_path / "diag_t5.000000e-01.npz")
    assert rec["time"] == 0.5 and np.array_equal(rec["Tavg"], np.arange(5.0))


def test_vtk_matches_jax(hs, tmp_path):
    cfg_j, cfg, dg, q, aux, q_j, _ = hs
    ours = vtk.readvtk(vtk.vtk_dump_state(str(tmp_path / "port"), dg, q))
    spec = cfg_j.model.prog_spec
    jfields = {n.replace(".", "_").replace("[", "_").rstrip("]"): q_j[..., i]
               for i, n in enumerate(spec.flattened_names())}
    ref = vtk.readvtk(jvtk.writevtk(str(tmp_path / "jax"), cfg_j.grid,
                                    jfields))
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        if r.dtype == np.int64:
            assert np.array_equal(ours[k], r), k
        else:
            assert ours[k].shape == r.shape
            assert np.max(np.abs(ours[k] - r)) <= 1e-9 * np.max(np.abs(r)), k
    assert sorted(ours) == sorted(["points", "connectivity", "offsets",
                                   "types", "rho", "rhou_0", "rhou_1",
                                   "rhou_2", "rhoe"])
    # on one grid the two files are the same text
    same = jvtk.writevtk(str(tmp_path / "jax_on_port_grid"), cfg.grid,
                         {k: v.reshape(cfg.grid.nelem, cfg.grid.Np)
                          for k, v in ours.items() if k[0] in "r"})
    assert open(same).read() == (tmp_path / "port.vtu").read_text()
    names = ["rho", "rhoe"]
    jvtk.writepvtu(str(tmp_path / "j"), ["a/p0", "a/p1"], names)
    vtk.writepvtu(str(tmp_path / "p"), ["a/p0", "a/p1"], names)
    assert (tmp_path / "j.pvtu").read_text() == \
        (tmp_path / "p.pvtu").read_text()


def test_readvtk_refuses_a_short_field(hs, tmp_path):
    _, _, dg, q, _, _, _ = hs
    path = vtk.vtk_dump_state(str(tmp_path / "s"), dg, q)
    text = open(path).read()
    i = text.index('Name="rhoe"')
    j = text.index("\n", text.index("\n", i) + 1)
    bad = text[:j] + " 1.0" + text[j:]          # one value too many
    open(path, "w").write(bad)
    with pytest.raises(ValueError, match="rhoe"):
        vtk.readvtk(path)


def test_state_check_matches_jax_and_checks():
    spec = VarSpec(a=1, b=2)
    arr = np.random.default_rng(1).standard_normal((10, 5, 3))
    jsc = JaxStateCheck(tracked=((lambda s: arr, spec, "Q"),))
    sc = StateCheck(tracked=(
        (lambda s: torch.tensor(arr).transpose(1, 2), spec, "Q"),))
    state = SimpleNamespace(q=None, aux=None, t=0.0, step=0)
    ref, snap = jsc.snapshot(state), sc.snapshot(state)
    assert list(snap) == list(ref)
    for key in ref:
        for stat in ("min", "max", "mean", "std"):
            assert abs(snap[key][stat] - ref[key][stat]) <= 1e-12 * abs(
                ref[key][stat]), (key, stat)
    ns = {}
    exec(sc.print_ref(), ns)
    assert sc.do_check(ns["refvals"], 1e-12)
    bad = {k: dict(v, mean=v["mean"] + 1.0) for k, v in ns["refvals"].items()}
    assert not sc.do_check(bad, 1e-12)
    assert [ln.split()[:3] for ln in sc.report(snap).splitlines()] == \
        [ln.split()[:3] for ln in jsc.report(ref).splitlines()]


def test_held_suarez_refvals(caplog):
    """tests/test_statecheck_refvals.py's run in the port: 30 LSRK54
    steps at 0.3 of the acoustic CFL on the generic DG operator, the
    statistics at that test's rtols; through a ``DiagnosticsConfiguration``
    of the StateCheck and ``solve``'s callbacks, every 10 steps."""
    from climatemachine_tpu_torch.driver.diagnostics_configs import \
        DiagnosticsConfiguration
    cfg = held_suarez_config(n_horz=2, n_vert=2, poly_order=3,
                             dtype=torch.float64, device="cpu")
    dg = DGModel(cfg.model, cfg.grid)
    q, aux = init_ode_state(dg)
    dt = 0.3 * min_node_distance(cfg.grid) / 350.0
    sc = StateCheck(tracked=((lambda st: st.q, cfg.model.prog_spec, "Q"),))
    cbs = DiagnosticsConfiguration((sc,), every_steps=10).make_callbacks(
        None, dt)
    with caplog.at_level(logging.INFO, logger="climatemachine"):
        st = solve(q, aux, LSRK54CarpenterKennedy(dg, dt), 30 * dt,
                   callbacks=cbs)
    assert st.step == 30 and len(sc.history) == 3
    assert sum("SC Q" in r.getMessage() for r in caplog.records) == 3
    refvals = _refvals()
    rtols = {k: 1e-6 for k in refvals}
    for i in range(3):
        rtols[("Q", f"rhou[{i}]")] = 1e-4
    assert sc.do_check(refvals, rtols)


def test_horizontal_average_and_default_group(hs, tmp_path):
    cfg_j, cfg, dg, q, aux, q_j, aux_j = hs
    g = cfg.grid
    r = torch.linalg.vector_norm(g.coords, dim=-1)
    ref = np.asarray(jmachine.horizontal_average(cfg_j.grid, jnp.asarray(
        r.numpy())))
    got = machine.horizontal_average(g, r).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))
    grp_j = jmachine.DiagnosticsGroup(
        "p", cfg_j.model, cfg_j.grid, jmachine.atmos_les_profiles(cfg_j.model))
    grp = machine.DiagnosticsGroup(
        "p", cfg.model, g, machine.atmos_les_profiles(cfg.model),
        writer=writers.NpzWriter(), out_path=str(tmp_path / "p.npz"))
    ref = grp_j.collect(q_j, aux_j)
    got = grp.write(q, aux, 0.0)
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        assert np.max(np.abs(got[k] - r)) <= 1e-12 * np.max(np.abs(r)), k
    assert np.array_equal(np.load(tmp_path / "p_t0.000000e+00.npz")["rho_avg"],
                          got["rho_avg"])


def test_single_stack_matches_jax(hs):
    cfg_j, cfg, _, q, _, q_j, _ = hs
    spec = cfg.model.prog_spec
    for fn, kw in (("get_vars_from_nodal_stack", dict(i=1, j=2, eh=5)),
                   ("get_horizontal_mean", {}),
                   ("get_horizontal_variance", {})):
        ref = getattr(jss, fn)(cfg_j.grid, jnp.asarray(q_j),
                               cfg_j.model.prog_spec, **kw)
        got = getattr(single_stack, fn)(cfg.grid, q, spec, **kw)
        assert list(got) == list(ref)
        for k, r in ref.items():
            r = np.asarray(r)
            assert np.max(np.abs(got[k] - r)) <= 1e-12 * max(
                np.max(np.abs(r)), 1e-300), (fn, k)


def test_tictoc():
    tictoc.reset()
    with tictoc.tictoc("off"):
        pass
    assert tictoc.timings() == {}
    tictoc.enable()
    try:
        for _ in range(2):
            with tictoc.tictoc("phase", sync=torch.zeros(1)):
                pass
    finally:
        tictoc.enable(False)
    assert tictoc.timings()["phase"].ncalls == 2
    assert "phase" in tictoc.report()
    tictoc.reset()


def _jax_source_vars(model, src):
    """The JAX package's ``_source_vars`` with the gradient flux of its
    node-major layout ``[E, Np, ngf]``: its own gives a ``(2, 3, 3,
    ngf)`` shape, which the sources that read the gradient flux
    (Subsidence, BomexTendencies) cannot broadcast, so its table lists
    them nowhere (a reference caveat)."""
    n, na, ng = (model.prog_spec.num, model.aux_spec.num,
                 model.gf_spec.num)
    shape = lambda k: jax.ShapeDtypeStruct((2, 3, k), jnp.float64)
    out = jax.eval_shape(
        lambda qq, aa, gg: src.contributions(model, qq, gg, aa, 0.0),
        shape(n), shape(na), shape(ng) if ng else None)
    return tuple(out.keys())


@pytest.mark.parametrize("case", ["held_suarez", "dycoms", "bomex"])
def test_show_tendencies_matches_jax(hs, case, monkeypatch):
    """The equation table equals the JAX package's, whose source
    discovery is given the gradient flux's node-major shape."""
    monkeypatch.setattr(jst, "_source_vars", _jax_source_vars)
    if case == "held_suarez":
        jm, m = hs[0].model, hs[1].model
    elif case == "dycoms":
        jm = flp.jax_dycoms()
        m = dycoms.dycoms_config((420.0, 420.0, 750.0), device="cpu").model
    else:
        jm = flp.jax_bomex("prescribed")
        m = bomex_les.bomex_config((1600.0, 1600.0, 750.0),
                                   dtype=torch.float64, device="cpu").model
    assert m.show_tendencies() == jm.show_tendencies()
    assert "?" not in m.show_tendencies()
