"""Top-level driver (port of ``climatemachine_tpu/driver/driver.py``
:29-270: ``Settings``, ``parse_interval``, ``parse_commandline``,
``get_setting``, ``init`` and ``invoke``).

Settings come from the command line, else the environment
(``CLIMATEMACHINE_SETTINGS_<NAME>``), else ``init``'s keywords, else the
defaults.  ``invoke`` runs a solver configuration to its end time with
the standard callbacks and returns norm(Q)/norm(Q₀).  Not ported, and
refused when a setting asks for them: diagnostics, VTK output, the
timestep and Courant monitors, adaptive time steps, checkpoints and
restarts.  The run's device is the configuration's (the card unless
its ``device`` or ``disable_gpu`` asks for the CPU, see
driver/configs.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import re
from dataclasses import dataclass
from typing import Optional, Sequence

logger = logging.getLogger("climatemachine")

_ENV_PREFIX = "CLIMATEMACHINE_SETTINGS_"


@dataclass
class Settings:
    """The JAX package's settings that the port reads or refuses (the
    intervals of callbacks that are not ported, checkpoints, restarts,
    ``debug_init``)."""
    disable_gpu: bool = False
    show_updates: str = "60secs"
    diagnostics: str = "never"
    vtk: str = "never"
    monitor_timestep_duration: str = "never"
    monitor_courant_numbers: str = "never"
    adapt_timestep: str = "never"
    checkpoint: str = "never"
    checkpoint_at_end: bool = False
    checkpoint_on_crash: bool = False
    restart_from_num: int = -1
    debug_init: bool = False
    log_level: str = "INFO"


SETTINGS = Settings()

#: interval settings that ask for a callback that is not ported
_NOT_PORTED_INTERVALS = {
    "diagnostics": "diagnostics", "vtk": "VTK output",
    "monitor_timestep_duration": "the timestep monitor",
    "monitor_courant_numbers": "the Courant monitor",
    "adapt_timestep": "adaptive time steps", "checkpoint": "checkpoints"}

_INTERVAL_RE = re.compile(
    r"^([0-9.]+)(smonths|sdays|shours|smins|ssecs|steps)$")


def parse_interval(spec: str, dt: float, day: float = 86400.0):
    """'1000steps' (steps), '3.3sdays' (simulated time: smonths, sdays,
    shours, smins, ssecs), '2hours' (wall time: hours, mins, secs) or
    'never'.  Returns ('steps', n), ('simtime', s), ('walltime', s) or
    None."""
    if spec in (None, "", "never"):
        return None
    m = _INTERVAL_RE.match(spec)
    if m:
        val, unit = float(m.group(1)), m.group(2)
        if unit == "steps":
            return ("steps", int(val))
        mult = {"smonths": 30 * day, "sdays": day, "shours": 3600.0,
                "smins": 60.0, "ssecs": 1.0}[unit]
        return ("simtime", val * mult)
    m2 = re.match(r"^([0-9.]+)(hours|mins|secs)$", spec)
    if m2:
        val, unit = float(m2.group(1)), m2.group(2)
        mult = {"hours": 3600.0, "mins": 60.0, "secs": 1.0}[unit]
        return ("walltime", val * mult)
    raise ValueError(f"unparsable interval: {spec!r}")


def _interval_callback(spec: str, dt: float, fn):
    from climatemachine_tpu_torch.driver import callbacks as cbs
    parsed = parse_interval(spec, dt)
    if parsed is None:
        return None
    kind, val = parsed
    if kind == "steps":
        return cbs.EveryXSimulationSteps(fn, int(val))
    if kind == "simtime":
        return cbs.EveryXSimulationTime(fn, val)
    return cbs.EveryXWallTimeSeconds(fn, val)


def parse_commandline(argv: Optional[Sequence[str]] = None,
                      custom_clargs: Optional[argparse.ArgumentParser] = None
                      ) -> dict:
    """``--flag-name value`` for each setting; unknown flags ignored."""
    p = custom_clargs or argparse.ArgumentParser("climatemachine")
    for f in dataclasses.fields(Settings):
        flag = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            p.add_argument(flag, type=lambda s: s.lower() in ("1", "true"),
                           default=None)
        elif isinstance(f.default, (int, float)):
            p.add_argument(flag, type=type(f.default), default=None)
        else:
            p.add_argument(flag, type=str, default=None)
    ns, _ = p.parse_known_args(argv)
    return {k: v for k, v in vars(ns).items() if v is not None}


def get_setting(name: str, cli: dict, kwargs: dict):
    """Command line, else environment, else keywords, else default."""
    if cli.get(name) is not None:
        return cli[name]
    env = os.environ.get(_ENV_PREFIX + name.upper())
    if env is not None:
        default = getattr(Settings(), name)
        if isinstance(default, bool):
            return env.lower() in ("1", "true", "yes")
        return type(default)(env)
    if name in kwargs:
        return kwargs[name]
    return getattr(Settings(), name)


def init(parse_clargs: bool = False, argv=None, custom_clargs=None,
         **kwargs) -> Settings:
    """Set :data:`SETTINGS` and logging."""
    cli = parse_commandline(argv, custom_clargs) if parse_clargs else {}
    for f in dataclasses.fields(Settings):
        setattr(SETTINGS, f.name, get_setting(f.name, cli, kwargs))
    logging.basicConfig(
        level=getattr(logging, SETTINGS.log_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    return SETTINGS


def _refuse_unported(diagnostics_config):
    if diagnostics_config is not None:
        raise NotImplementedError("next slice: diagnostics")
    for name, what in _NOT_PORTED_INTERVALS.items():
        if parse_interval(getattr(SETTINGS, name), 1.0) is not None:
            raise NotImplementedError(f"next slice: {what} ({name}="
                                      f"{getattr(SETTINGS, name)!r})")
    if (SETTINGS.checkpoint_at_end or SETTINGS.checkpoint_on_crash
            or SETTINGS.restart_from_num >= 0):
        raise NotImplementedError("next slice: checkpoints and restarts")


def invoke(solver_config, user_callbacks: Sequence = (),
           diagnostics_config=None, check_cons: Sequence = ()) -> float:
    """Run ``solver_config`` from t0 to its ``timeend`` with the user's
    callbacks, the summary log of ``show_updates`` and the conservation
    checks ``check_cons``; leave the final state in ``solver_config.q``
    and ``.aux``.  Returns norm(Q)/norm(Q₀) (M-weighted)."""
    from climatemachine_tpu_torch.dg.reductions import norm
    from climatemachine_tpu_torch.driver import callbacks as cbs
    from climatemachine_tpu_torch.ode.solve import solve

    _refuse_unported(diagnostics_config)
    sc = solver_config
    callbacks = list(user_callbacks)
    summary = _interval_callback(SETTINGS.show_updates, sc.dt,
                                 cbs.SummaryLog(sc.dg.grid).make().fn)
    if summary is not None:
        callbacks.append(summary)
    callbacks.extend(check.make() for check in check_cons)

    eng0 = float(norm(sc.dg.grid, sc.q))
    logger.info("starting: norm(Q) = %.16e", eng0)
    state = solve(sc.q, sc.aux, sc.solver, sc.timeend, t0=sc.t0,
                  callbacks=callbacks)
    sc.q, sc.aux = state.q, state.aux
    engf = float(norm(sc.dg.grid, state.q))
    logger.info("finished: norm(Q) = %.16e  ratio %.16e", engf,
                engf / eng0 if eng0 else float("nan"))
    return engf / eng0 if eng0 else float("nan")
