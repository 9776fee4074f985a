"""Build the port's CUDA sources at first use.

Each ``csrc/<name>.cu`` is compiled with nvcc for ``sm_90a`` into a shared
library with a plain C interface, ``_build/lib<name>_<hash>.so`` inside the
package (named by the hash of the source and of csrc/'s headers, so an
edited source or header is rebuilt), and
loaded with ctypes.  :func:`build` starts one nvcc per source, all at once,
and waits for them together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by the hash of the source
    and of the headers of csrc/ (which a source may include)."""
    h = hashlib.sha256((SOURCE_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(*names: str) -> dict:
    """Compile ``csrc/<name>.cu`` for each name whose library for the
    current source is not built yet, one nvcc each, in parallel.  Returns
    ``{name: {"path", "built", "seconds", "log"}}``; the log holds
    ptxas's register and shared-memory report."""
    out, running = {}, {}
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            out[name] = {"path": str(lib), "built": False, "seconds": 0.0,
                         "log": ""}
            continue
        nvcc = _nvcc()
        if not os.path.isfile(nvcc):
            raise RuntimeError(f"nvcc not found on PATH or at {nvcc}: the "
                               "CUDA kernels build where the CUDA toolkit is")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(SOURCE_DIR / f"{name}.cu")]
        running[name] = (lib, tmp, cmd, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, cmd, t0, proc) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = {"path": str(lib), "built": True, "seconds": seconds,
                     "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built first if needed)."""
    return ctypes.CDLL(build(name)[name]["path"])


def check_aligned(name: str, **tensors):
    """Raise ValueError unless each tensor starts on a 16-byte boundary:
    the kernels that stage their inputs with TMA bulk copies
    (csrc/tile_pipeline.cuh) need it; a fresh allocation always does."""
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} {key}: need a 16-byte aligned tensor, "
                             f"got one at offset {t.data_ptr() % 16}")
