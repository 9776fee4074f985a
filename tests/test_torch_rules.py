"""Rules of the PyTorch port that hold without a card: it imports no JAX,
entry points refuse to fall back to the CPU, and the volume kernel's
wrapper refuses what its kernel does not cover instead of quietly
running the plain version."""

import ast
import pathlib
from dataclasses import replace

import pytest
import torch

from climatemachine_tpu_torch import resolve_device
from climatemachine_tpu_torch.atmos.model import AtmosModel
from climatemachine_tpu_torch.dg import volume_kernel
from climatemachine_tpu_torch.dg.fast_rhs import VarMajorRHS
from climatemachine_tpu_torch.dg.spatial import DGModel
from climatemachine_tpu_torch.experiments.held_suarez import \
    held_suarez_config
from climatemachine_tpu_torch.physics.parameters import EARTH

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
    dict(nq=6), dict(has_f2=True), dict(lin_dims=(2,)),
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


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(volume_kernel, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(volume_kernel.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        volume_kernel.build()


def test_next_slice_configurations_raise():
    with pytest.raises(NotImplementedError, match="next slice"):
        held_suarez_config(2, 2, 3, dtype=torch.float64, device="cpu")
    cfg = held_suarez_config(2, 2, 3, dtype=torch.float64,
                             hyperdiffusion_tau=None, device="cpu")
    with pytest.raises(NotImplementedError, match="next slice"):
        VarMajorRHS(DGModel(cfg.model, cfg.grid, remainder=("linear",
                                                            "vertical")))
    m = cfg.model
    hyper = AtmosModel(replace(m.physics, hyperdiffusion="biharmonic"),
                       m.problem, m.sources)
    with pytest.raises(NotImplementedError, match="next slice"):
        VarMajorRHS(DGModel(hyper, cfg.grid))
