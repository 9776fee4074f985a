"""Rules of the PyTorch port that hold without a card: it imports no JAX,
entry points refuse to fall back to the CPU, and the kernel wrappers
refuse what their kernels do not cover instead of quietly running the
plain version."""

import ast
import pathlib
from dataclasses import replace

import pytest
import torch

from climatemachine_tpu.dg.spatial import \
    direction_dims as jax_direction_dims
from climatemachine_tpu.dg.spatial import \
    direction_faces as jax_direction_faces
from climatemachine_tpu_torch import cuda_build, resolve_device
from climatemachine_tpu_torch.atmos.hyperdiffusion import DryBiharmonic
from climatemachine_tpu_torch.atmos.linear import \
    AtmosAcousticGravityLinearModel
from climatemachine_tpu_torch.atmos.model import AtmosModel
from climatemachine_tpu_torch.dg import ldg_kernel, ldg_tables, volume_kernel
from climatemachine_tpu_torch.dg.fast_rhs import VarMajorRHS
from climatemachine_tpu_torch.dg.spatial import (DGModel, direction_dims,
                                                 direction_faces,
                                                 init_ode_state)
from climatemachine_tpu_torch.driver.solver_types import IMEXSolverType
from climatemachine_tpu_torch.experiments.held_suarez import \
    held_suarez_config
from climatemachine_tpu_torch.ode.ark import ARK2GiraldoKellyConstantinescu
from climatemachine_tpu_torch.physics.parameters import EARTH
from climatemachine_tpu_torch.solvers import layout_kernel
from climatemachine_tpu_torch.solvers.columnwise import (ColumnLayout,
                                                         ManyColumnSolver)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "climatemachine_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "climatemachine_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        held_suarez_config(2, 2, 3, hyperdiffusion_tau=None)
    assert resolve_device("cpu") == torch.device("cpu")


def _meta_args(nq=5, E=8, Np=64):
    t = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")
    return (t(E, nq, Np), t(E, Np), t(E, Np), t(E, Np), t(E, 3, Np),
            t(E, 12, Np), t(E, 2, Np), t(E, 9, Np), t(E, Np), t(E, Np),
            t(Np, 3 * Np))


@pytest.mark.parametrize("flags", [
    dict(nq=6), dict(has_f2=True, ngl=5), dict(lin_dims=(2,)),
    dict(subtract_ref=False)], ids=["nq6", "has_f2", "lin_dims", "no_subtract"])
def test_kernel_wrapper_refuses_unsupported_flags(flags):
    kw = dict(nq=5, ngl=4, R_d=EARTH.R_d, cv_d=EARTH.cv_d, T_0=EARTH.T_0)
    kw.update(flags)
    with pytest.raises(NotImplementedError):
        volume_kernel.fused_volume_tendency_vm(*_meta_args(kw["nq"]), **kw)


def test_kernel_wrapper_never_falls_back_off_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which
    refuses a non-CUDA device instead of running the plain version."""
    kw = dict(nq=5, ngl=1, R_d=EARTH.R_d, cv_d=EARTH.cv_d, T_0=EARTH.T_0)
    before = volume_kernel.fused_volume_tendency_vm.launches
    with pytest.raises(ValueError):
        volume_kernel.fused_volume_tendency_vm(*_meta_args(), **kw)
    assert volume_kernel.fused_volume_tendency_vm.launches == before


def _chain_meta_args(stage, E=8, n=4, nd=2, Np=64, F=64):
    t = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")
    i = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")
    fo = ldg_tables.FaceOps(Sel=t(Np, F), LT=t(F, Np), sel_idx=i(F),
                            lift_idx=i(Np, 2))
    xi, Wd, MI = t(E, nd * 3, Np), t(nd, Np, Np), t(E, Np)
    return {"ldg_first": (t(E, n, Np), xi, Wd, fo),
            "ldg_grad_to_div": (t(E, 3, n, Np), t(E, n, F), t(E, 3, F),
                                t(E, 3, F), MI, xi, Wd, fo),
            "ldg_div_to_grad": (t(E, n, Np), t(E, n, F), t(E, F), MI, xi,
                                Wd, fo),
            "ldg_last": (t(E, 3, n, Np), t(E, n, F), t(E, 3, F), MI,
                         fo)}[stage]


@pytest.mark.parametrize("stage", ["ldg_first", "ldg_grad_to_div",
                                   "ldg_div_to_grad", "ldg_last"])
def test_chain_wrapper_never_falls_back_off_cpu(stage):
    """A chain tensor that is not on the CPU goes to the kernel path,
    which refuses a non-CUDA device and counts no launch."""
    wrapper = getattr(ldg_kernel, stage)
    before = wrapper.launches
    with pytest.raises(ValueError):
        wrapper(*_chain_meta_args(stage))
    assert wrapper.launches == before


@pytest.mark.parametrize("name", ["to_blocks_vm", "from_blocks_vm"])
def test_layout_wrapper_never_falls_back_off_cpu(name):
    """A layout tensor that is not on the CPU goes to the kernel path,
    which refuses a non-CUDA device and counts no launch."""
    wrapper = getattr(layout_kernel, name)
    dims = (4, 2, 5, 3, 9)
    shape = (8, 5, 27) if name == "to_blocks_vm" else (2, 15, 36)
    before = wrapper.launches
    with pytest.raises(ValueError):
        wrapper(torch.empty(shape, dtype=torch.float32, device="meta"), dims)
    assert wrapper.launches == before


@pytest.mark.parametrize("source", ["volume_vm", "ldg_chain",
                                    "column_layout", "surface_vm"])
def test_build_without_nvcc_raises(monkeypatch, tmp_path, source):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build(source)


class _OtherBiharmonic(DryBiharmonic):
    """A hyperdiffusion that is not DryBiharmonic itself (the moist one
    waits for moisture)."""


def test_next_slice_configurations_raise():
    cfg = held_suarez_config(2, 2, 3, dtype=torch.float64, device="cpu")
    assert type(cfg.model.physics.hyperdiffusion) is DryBiharmonic
    VarMajorRHS(DGModel(cfg.model, cfg.grid))      # the default now builds
    with pytest.raises(NotImplementedError, match="next slice"):
        VarMajorRHS(DGModel(cfg.model, cfg.grid, remainder=("linear",
                                                            "vertical")))
    m = cfg.model
    hyper = AtmosModel(replace(m.physics,
                               hyperdiffusion=_OtherBiharmonic(3600.0)),
                       m.problem, m.sources)
    with pytest.raises(NotImplementedError, match="next slice"):
        VarMajorRHS(DGModel(hyper, cfg.grid))

    # the generic DG operator: gradient (hyperdiffusive) state, the full
    # AtmosModel, a remainder
    dg = DGModel(cfg.model, cfg.grid)
    q, aux = init_ode_state(dg)
    with pytest.raises(NotImplementedError, match="next slice"):
        dg(q, aux, 0.0)
    with pytest.raises(NotImplementedError, match="next slice"):
        DGModel(AtmosAcousticGravityLinearModel(m), cfg.grid,
                remainder=("linear", "vertical"))(q, aux, 0.0)

    # IMEX: the grid layout, the dense solver, a sharded model, the ARK
    # step without a block-layout exact solve (JAX ark.py _step_impl), a
    # reduced-precision operator
    dt = 10.0
    for kw in (dict(state_layout="grid"), dict(columnwise_solver="dense")):
        with pytest.raises(NotImplementedError, match="next slice"):
            IMEXSolverType(**kw).make(dg, q, aux, dt)

    class _Sharded(DGModel):
        inner, mesh = None, None

    with pytest.raises(NotImplementedError, match="next slice"):
        IMEXSolverType().make(_Sharded(m, cfg.grid), q, aux, dt)
    lin = DGModel(AtmosAcousticGravityLinearModel(m), cfg.grid,
                  direction="vertical", update_aux=False)
    op = lambda x: lin(x, aux, 0.0)[0]
    dense = ManyColumnSolver(op, ColumnLayout(cfg.grid, 5), q)
    ark = ARK2GiraldoKellyConstantinescu(None, None, dense, dt)
    with pytest.raises(NotImplementedError, match="next slice"):
        ark.step(q, aux, 0.0)
    imex = IMEXSolverType().make(dg, q, aux, dt)
    with pytest.raises(NotImplementedError, match="next slice"):
        imex.solver.op_args(torch.bfloat16)


@pytest.mark.parametrize("direction", ["every", "horizontal", "vertical"])
def test_directions_match_jax(direction):
    """Reference dims and faces of each direction, as the JAX package
    gives them."""
    assert direction_dims(direction, 3) == jax_direction_dims(direction, 3)
    assert direction_faces(direction, 3) == \
        jax_direction_faces(direction, 3)
    with pytest.raises(ValueError):
        direction_dims("diagonal", 3)
