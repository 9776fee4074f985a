"""StateCheck: per-field statistics for regression and debugging (port
of ``climatemachine_tpu/diagnostics/state_check.py``: ``snapshot``,
``report``, ``make_callback``, ``print_ref``, ``do_check``).

A snapshot takes min, max, mean and std (n − 1 in the denominator, as
the reference's refvals tables define it) of each lane of a var-major
array ``[E, n, Np]``, in float64 on the array's device, and copies the
``[4, n]`` table to the host once.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

logger = logging.getLogger("climatemachine")

STATS = ("min", "max", "mean", "std")


def lane_stats(arr) -> List[Dict[str, float]]:
    """Each lane's {min, max, mean, std} of var-major ``arr`` ``[E, n,
    Np]``."""
    a = arr.detach().double().transpose(0, 1).reshape(arr.shape[1], -1)
    std = (a.std(dim=1) if a.shape[1] > 1 else torch.zeros_like(a[:, 0]))
    table = torch.stack([a.amin(dim=1), a.amax(dim=1), a.mean(dim=1),
                         std]).cpu().tolist()
    return [dict(zip(STATS, col)) for col in zip(*table)]


@dataclass
class StateCheck:
    """Track (getter(state) → var-major array, VarSpec, label) groups;
    snapshot their statistics every ``every_steps`` steps."""
    tracked: Sequence[Tuple] = ()
    every_steps: int = 10
    history: List[Dict] = field(default_factory=list)

    def snapshot(self, state) -> Dict:
        snap = {}
        for getter, spec, label in self.tracked:
            for name, s in zip(spec.flattened_names(),
                               lane_stats(getter(state))):
                snap[(label, name)] = s
        self.history.append(snap)
        return snap

    def report(self, snap: Dict) -> str:
        lines = ["# SC +++ label  var  min  max  mean  std"]
        for (label, name), s in snap.items():
            lines.append(f"SC {label:10s} {name:24s} "
                         f"{s['min']: .10e} {s['max']: .10e} "
                         f"{s['mean']: .10e} {s['std']: .10e}")
        return "\n".join(lines)

    def make_callback(self, every_steps: Optional[int] = None):
        """A driver callback that snapshots and logs the report every
        ``every_steps`` steps (``self.every_steps`` when None, so that a
        ``DiagnosticsConfiguration`` can hold this check beside its
        groups)."""
        from climatemachine_tpu_torch.driver.callbacks import \
            EveryXSimulationSteps

        def fn(state):
            logger.info("%s", self.report(self.snapshot(state)))

        return EveryXSimulationSteps(fn, every_steps or self.every_steps)

    # --- refvals ------------------------------------------------------------
    def print_ref(self) -> str:
        """A refvals python literal of the last snapshot."""
        if not self.history:
            raise ValueError("no snapshots collected")
        snap = self.history[-1]
        out = ["refvals = {"]
        for (label, name), s in snap.items():
            out.append(f"  ({label!r}, {name!r}): "
                       f"{{'min': {s['min']!r}, 'max': {s['max']!r}, "
                       f"'mean': {s['mean']!r}, 'std': {s['std']!r}}},")
        out.append("}")
        return "\n".join(out)

    def do_check(self, refvals: Dict, rtols: Dict, snap: Optional[Dict] = None
                 ) -> bool:
        """Compare the (last) snapshot against ``refvals`` with per-field
        relative tolerances ``rtols`` (a dict, 1e-7 where it has no
        entry, or one number); logs each miss and returns pass/fail."""
        snap = snap or self.history[-1]
        ok = True
        for key, ref in refvals.items():
            rtol = rtols.get(key, 1e-7) if isinstance(rtols, dict) else rtols
            got = snap.get(key)
            if got is None:
                logger.error("statecheck: missing %s", key)
                ok = False
                continue
            for stat in STATS:
                denom = max(abs(ref[stat]), 1e-30)
                rel = abs(got[stat] - ref[stat]) / denom
                if rel > rtol:
                    logger.error(
                        "statecheck: %s %s rel err %.3e > %.3e "
                        "(got %.10e want %.10e)", key, stat, rel, rtol,
                        got[stat], ref[stat])
                    ok = False
        return ok
