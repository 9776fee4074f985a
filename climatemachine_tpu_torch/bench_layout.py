"""The layout kernels' design variants against PyTorch's own copy, on the card.

    python -m climatemachine_tpu_torch.bench_layout [--rounds N]
        [--launches N] [--inputs N] [--parent-source PATH] [--out DIR]

At the IMEX step's layout dims (Eh, nv, nvars, Nq3, ji) = (1536, 8, 5, 5,
25) in float32 (30.72 MB each way), for ``to_blocks`` and
``from_blocks``, times the wrapper of ``csrc/column_layout.cu``, the
plain version (one ``permute`` copy: the library call), ``clone()`` (a
plain copy of the same bytes, the practical ceiling) and the design's
variants: the same source rebuilt with one of its constants changed
(:data:`VARIANTS`: the tile of eh, the threads a block, the y side kept
scalar, the dims at run time), each built by nvcc beside the others.
``--parent-source`` adds an earlier ``column_layout.cu`` with the same C
entry points, as it is and, for the one-thread-per-element kernel of
PR 3 (the line :data:`PARENT_ANCHOR`), with the bench dims as constants.
Every contender is first held bit for bit against the plain version at
the bench shape and (all but the fixed-dims build) at an odd Eh with a
tail tile, then timed by
:func:`timing.paired_rounds`: interleaved rounds of CUDA-graph replays
rotating through ``--inputs`` distinct inputs (cold L2: 4 × 30.72 MB >
the 50 MB L2), then on one input (warm).  Also reports the host time of
one call (enqueue, no synchronisation) and, where the toolkit has
``cuobjdump``, each build's SASS: instructions a kernel and the
``I2F*.RP`` (reciprocal estimate) that opens each 32-bit division by a
runtime value.

Prints one JSON line per direction and writes them, with the SASS
counts, to ``DIR/bench_layout.json`` (default profile_out/).  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch

from climatemachine_tpu_torch import cuda_build
from climatemachine_tpu_torch.solvers import layout_kernel
from climatemachine_tpu_torch.timing import PEAK_BYTES, paired_rounds

DIMS = (1536, 8, 5, 5, 25)
EDGE = (37, 2, 5, 5, 25)
_TILE = "constexpr int TILE = 8;"
_TO = "constexpr int TO_BLOCKS_THREADS = 256;"
_FROM = "constexpr int FROM_BLOCKS_THREADS = 512;"
#: variant -> the (line of csrc/column_layout.cu, replacement) it builds
VARIANTS = {
    "tile4": [(_TILE, "constexpr int TILE = 4;")],
    "tile16": [(_TILE, "constexpr int TILE = 16;")],
    "threads128": [(_TO, _TO.replace("256", "128")),
                   (_FROM, _FROM.replace("512", "128"))],
    "threads256": [(_FROM, _FROM.replace("512", "256"))],
    "threads512": [(_TO, _TO.replace("256", "512"))],
    "scalar_y": [("const bool use_vec = ", "const bool use_vec = false && ")],
    "runtime_dims": [("if (NVARS == 5 && NQ3 == 5 && JI == 25 && tile == "
                      "TILE)", "if (false)")],
}
#: a line of PR 3's one-thread-per-element kernel before its first use of
#: the dims; its fixed-dims build assigns the bench dims there, so that
#: the compiler turns its divisions into multiply-shift sequences
PARENT_ANCHOR = "  const Index stride = (Index)gridDim.x * THREADS;\n"


def patched(text: str, patches) -> str:
    for old, new in patches:
        if old not in text:
            raise ValueError(f"bench_layout: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def build_sources(sources: dict) -> dict:
    """Compile each ``{key: source text}`` with cuda_build's flags, one
    nvcc each, all at once; ``{key: (CDLL, path)}``."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, text in sources.items():
        src = cuda_build.BUILD_DIR / f"column_layout_{key}.cu"
        src.write_text(text)
        path = cuda_build.BUILD_DIR / f"libcolumn_layout_{key}.so"
        procs[key] = (path, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(path),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for key, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(str(path))
        for fn in (lib.to_blocks_f32, lib.from_blocks_f32):
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[key] = (lib, path)
    return libs


def shape(to_blocks: bool, dims, out: bool):
    Eh, nv, nvars, Nq3, ji = dims
    y = (nv, Nq3 * nvars, Eh * ji)
    x = (Eh * nv, nvars, Nq3 * ji)
    return y if to_blocks == out else x


def entry_call(lib, to_blocks: bool, dims):
    """A built library's entry point on a fresh output, on the current
    stream."""
    fn = lib.to_blocks_f32 if to_blocks else lib.from_blocks_f32

    def call(x):
        out = torch.empty(shape(to_blocks, dims, True), dtype=x.dtype,
                          device=x.device)
        code = fn(x.data_ptr(), out.data_ptr(), *dims,
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"layout kernel launch failed ({code})")
        return out
    return call


def sass_counts(path) -> dict:
    """Per kernel of a built library: SASS instructions and runtime
    divisions, from cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return {"error": "no cuobjdump"}
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {"instructions": 0, "runtime_divisions": 0}
        elif name and re.search(r"/\*[0-9a-f]{4}\*/", line):
            out[name]["instructions"] += 1
            out[name]["runtime_divisions"] += bool(
                re.search(r"I2F\S*\.RP", line))
    return out


def host_us(fn, x, n: int = 200) -> float:
    """Host time of one call in µs: ``n`` calls enqueued back to back."""
    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(x)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


def direction(libs: dict, to_blocks: bool, args) -> dict:
    name = "to_blocks_vm" if to_blocks else "from_blocks_vm"
    plain = getattr(layout_kernel, name + "_plain")
    wrapper = getattr(layout_kernel, name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = [torch.randn(shape(to_blocks, DIMS, False), generator=gen,
                          device="cuda") for _ in range(args.inputs)]
    edge = torch.randn(shape(to_blocks, EDGE, False), generator=gen,
                       device="cuda")
    contenders = {"wrapper": lambda x: wrapper(x, DIMS),
                  "plain": lambda x: plain(x, DIMS),
                  "copy": lambda x: x.clone()}
    exact = {"wrapper": torch.equal(wrapper(inputs[0], DIMS),
                                    plain(inputs[0], DIMS))
             and torch.equal(wrapper(edge, EDGE), plain(edge, EDGE))}
    for key, (lib, _) in libs.items():
        contenders[key] = entry_call(lib, to_blocks, DIMS)
        exact[key] = torch.equal(contenders[key](inputs[0]),
                                 plain(inputs[0], DIMS))
        if key != "parent_fixed_dims":       # holds only the bench dims
            exact[key] &= torch.equal(entry_call(lib, to_blocks, EDGE)(edge),
                                      plain(edge, EDGE))
    torch.cuda.synchronize()
    cold = paired_rounds(contenders, inputs, args.rounds, args.launches)
    warm = paired_rounds(contenders, inputs[:1], args.rounds, args.launches)
    nbytes = 2 * inputs[0].numel() * inputs[0].element_size()
    bound = 1e3 * nbytes / PEAK_BYTES
    lib_med = statistics.median(cold["plain"])
    rows = {key: dict(exact=exact.get(key),
                      ms=statistics.median(cold[key]), ms_min=min(cold[key]),
                      ms_max=max(cold[key]),
                      ms_warm=statistics.median(warm[key]),
                      over_library=statistics.median(cold[key]) / lib_med,
                      share_of_bound=bound / statistics.median(cold[key]))
            for key in contenders}
    host = {key: host_us(contenders[key], inputs[0])
            for key in ("wrapper", "plain")}
    return dict(kernel=name, dims=DIMS, bytes=nbytes, bound_ms=bound,
                inputs=args.inputs, rounds=args.rounds,
                launches=args.launches, host_us_per_call=host,
                contenders=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--inputs", type=int, default=4)
    ap.add_argument("--parent-source", type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("profile_out"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_layout: no CUDA device", file=sys.stderr)
        return 1
    text = (cuda_build.SOURCE_DIR / "column_layout.cu").read_text()
    sources = {key: patched(text, p) for key, p in VARIANTS.items()}
    if args.parent_source is not None:
        parent = args.parent_source.read_text()
        sources["parent"] = parent
        if PARENT_ANCHOR in parent:
            Eh, nv, nvars, Nq3, ji = DIMS
            sources["parent_fixed_dims"] = parent.replace(
                PARENT_ANCHOR, f"  Eh = {Eh}; NV = {nv}; NVARS = {nvars}; "
                f"NQ3 = {Nq3}; JI = {ji};\n" + PARENT_ANCHOR)
    libs = build_sources(sources)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    results = [direction(libs, to, args) for to in (True, False)]
    sass = {"shipped": sass_counts(cuda_build.build("column_layout")
                                   ["column_layout"]["path"])}
    for key in ("parent", "parent_fixed_dims"):
        if key in libs:
            sass[key] = sass_counts(libs[key][1])
    args.out.mkdir(parents=True, exist_ok=True)
    with open(args.out / "bench_layout.json", "w") as f:
        json.dump(dict(card=card, results=results, sass=sass), f, indent=1)
    for res in results:
        print(json.dumps(dict(card=card, **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
