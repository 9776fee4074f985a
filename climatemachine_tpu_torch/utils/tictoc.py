"""Lightweight phase timing (port of ``climatemachine_tpu/utils/
tictoc.py``): per-site call counts and wall time, off by default.

``tictoc(name, sync=x)`` synchronises x's CUDA device before it stops
the clock, so that kernel time is charged to the phase that launched
it."""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict

import torch

_ENABLED = False
_TIMINGS: Dict[str, "TimingInfo"] = {}


@dataclass
class TimingInfo:
    ncalls: int = 0
    time: float = 0.0


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


def reset():
    _TIMINGS.clear()


def timings() -> Dict[str, TimingInfo]:
    return dict(_TIMINGS)


@contextmanager
def tictoc(name: str, sync=None):
    """``with tictoc("phase", sync=t): ...`` times the block; with
    ``sync`` a tensor on a card, that card is synchronised first."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        info = _TIMINGS.setdefault(name, TimingInfo())
        info.ncalls += 1
        info.time += time.perf_counter() - t0


def report() -> str:
    lines = ["# tictoc: site  ncalls  total_s  per_call_ms"]
    for name, info in sorted(_TIMINGS.items()):
        per = 1e3 * info.time / max(info.ncalls, 1)
        lines.append(f"{name:30s} {info.ncalls:8d} {info.time:10.3f} "
                     f"{per:10.3f}")
    return "\n".join(lines)
