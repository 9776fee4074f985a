"""Device timing on the card, shared by ``chip_smoke.py`` and the layout
kernels' design study (``bench_layout.py``): the H100's peak rates that
the bounds divide by, and interleaved rounds of CUDA-graph replays."""

from __future__ import annotations

import torch

PEAK_FP32_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3


def paired_rounds(contenders: dict, inputs: list, rounds: int = 9,
                  launches: int = 20) -> dict:
    """Device ms per call of each contender ``fn(x)``, one figure per
    round.  Each contender's ``launches`` calls, rotating through
    ``inputs``, are captured once as a CUDA graph (after a warm-up call
    on each input), so the host's launch cost does not enter the figure;
    every round replays each graph between two CUDA events, in the order
    of ``contenders``, reversed every other round."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in contenders.values():
            for x in inputs:
                fn(x)
    torch.cuda.current_stream().wait_stream(side)
    pool = torch.cuda.graph_pool_handle()
    graphs = {}
    for name, fn in contenders.items():
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name], pool=pool):
            for i in range(launches):
                fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    names = list(contenders)
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[name].replay()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / launches)
    del graphs
    torch.cuda.empty_cache()
    return times
