"""Top-level driver (port of ``climatemachine_tpu/driver/driver.py``
:29-270: ``Settings``, ``parse_interval``, ``parse_commandline``,
``get_setting``, ``init`` and ``invoke``).

Settings come from the command line, else the environment
(``CLIMATEMACHINE_SETTINGS_<NAME>``), else ``init``'s keywords, else the
defaults.  ``invoke`` runs a solver configuration to its end time with
the standard callbacks and returns norm(Q)/norm(Q₀): the summary log
(``show_updates``), the timestep and Courant monitors
(``monitor_timestep_duration``, ``monitor_courant_numbers``), adaptive
time steps (``adapt_timestep``), checkpoints every ``checkpoint``
interval into ``checkpoint_dir`` (``checkpoint_keep_one``), at the end
(``checkpoint_at_end``) and at the step that crashed
(``checkpoint_on_crash``), number 9999 both; ``restart_from_num`` is
read by the experiment scripts, which pass it to
``make_solver_configuration(restart_from=...)``.  A step interval fires
every N steps; a simulated-time or wall-time interval fires as the
summary log's does (the JAX package runs its monitors every 100 steps
whatever the interval says; the port takes the interval).  Diagnostics
come from ``invoke``'s ``diagnostics_config``; the ``diagnostics`` and
``vtk`` interval settings, which the JAX package's ``invoke`` reads
nowhere, are refused with a message that says so.
The run's device is the configuration's (the card unless its
``device`` or ``disable_gpu`` asks for the CPU, see driver/configs.py).
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
    ``diagnostics`` and ``vtk`` intervals); ``debug_init`` writes the
    initial state's VTK dump into ``output_dir``."""
    disable_gpu: bool = False
    show_updates: str = "60secs"
    diagnostics: str = "never"
    vtk: str = "never"
    monitor_timestep_duration: str = "never"
    monitor_courant_numbers: str = "never"
    adapt_timestep: str = "never"
    checkpoint: str = "never"
    checkpoint_keep_one: bool = True
    checkpoint_at_end: bool = False
    checkpoint_on_crash: bool = False
    checkpoint_dir: str = "checkpoint"
    restart_from_num: int = -1
    debug_init: bool = False
    log_level: str = "INFO"
    output_dir: str = "output"


SETTINGS = Settings()

#: interval settings that no callback reads (nor does the JAX package's
#: ``invoke``), with what to use instead
_REFUSED_INTERVALS = {
    "diagnostics": "pass invoke(..., diagnostics_config="
                   "DiagnosticsConfiguration(groups, every_steps))",
    "vtk": "pass a user callback that calls io.vtk.vtk_dump_state"}

#: the number of the checkpoints written at the end and on a crash
FINAL_CHECKPOINT = 9999

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


def _refuse_intervals():
    for name, instead in _REFUSED_INTERVALS.items():
        if parse_interval(getattr(SETTINGS, name), 1.0) is not None:
            raise NotImplementedError(
                f"the {name}={getattr(SETTINGS, name)!r} setting is read "
                f"by no callback (nor by the JAX package's invoke): "
                f"{instead}")


def _every(spec: str, dt: float, make):
    """``make(n)``, a callback every n steps, for a step interval; for a
    simulated-time or wall-time one ``make(1)``'s ``fn`` behind
    :func:`_interval_callback`; None for 'never'."""
    parsed = parse_interval(spec, dt)
    if parsed is None:
        return None
    if parsed[0] == "steps":
        return make(int(parsed[1]))
    return _interval_callback(spec, dt, make(1).fn)


def standard_callbacks(sc) -> list:
    """The callbacks the settings ask for on configuration ``sc``, in the
    JAX package's order: summary log, timestep monitor, Courant monitor,
    adaptive time step, checkpoints."""
    from climatemachine_tpu_torch.driver import callbacks as cbs
    S, dt = SETTINGS, sc.dt
    makers = (
        (S.show_updates,
         lambda n: cbs.SummaryLog(sc.dg.grid, every_steps=n).make()),
        (S.monitor_timestep_duration,
         lambda n: cbs.MonitorTimestepDuration(every_steps=n).make()),
        (S.monitor_courant_numbers,
         lambda n: cbs.MonitorCourant(sc.dg.grid, sc.dg.balance_law, dt,
                                      every_steps=n).make()),
        (S.adapt_timestep,
         lambda n: cbs.AdaptTimestep(sc, every_steps=n).make()),
        (S.checkpoint,
         lambda n: cbs.CheckpointCallback(
             S.checkpoint_dir, sc.name, every_steps=n,
             keep_one=S.checkpoint_keep_one).make()))
    return [cb for cb in (_every(spec, dt, make) for spec, make in makers)
            if cb is not None]


class _StateTracker:
    """The first callback: keeps the state of the last completed step, so
    that a crash checkpoint holds the state at the crash (also when a
    later callback is what raises)."""
    state = None

    def call(self, state):
        self.state = state
        return False


def invoke(solver_config, user_callbacks: Sequence = (),
           diagnostics_config=None, check_cons: Sequence = ()) -> float:
    """Run ``solver_config`` from t0 to its ``timeend`` with the user's
    callbacks, those the settings ask for (:func:`standard_callbacks`),
    the conservation checks ``check_cons`` and the callbacks of
    ``diagnostics_config`` (a ``DiagnosticsConfiguration``, its groups
    fired on its step interval); leave the final state in
    ``solver_config.q`` and ``.aux``.  With ``checkpoint_on_crash`` an
    exception from the run first writes checkpoint 9999 of the last
    completed step (of the initial state before the first), then
    propagates.  Returns norm(Q)/norm(Q₀) (M-weighted)."""
    from climatemachine_tpu_torch.dg.reductions import norm
    from climatemachine_tpu_torch.driver import checkpoint as cp
    from climatemachine_tpu_torch.ode.solve import solve

    _refuse_intervals()
    sc = solver_config
    tracker = _StateTracker()
    callbacks = [tracker, *user_callbacks, *standard_callbacks(sc)]
    callbacks.extend(check.make() for check in check_cons)
    if diagnostics_config is not None:
        callbacks.extend(diagnostics_config.make_callbacks(sc, sc.dt))

    eng0 = float(norm(sc.dg.grid, sc.q))
    logger.info("starting: norm(Q) = %.16e", eng0)
    try:
        state = solve(sc.q, sc.aux, sc.solver, sc.timeend, t0=sc.t0,
                      callbacks=callbacks)
    except Exception:
        if SETTINGS.checkpoint_on_crash:
            st = tracker.state
            if st is not None:
                cp.write_checkpoint(SETTINGS.checkpoint_dir, sc.name,
                                    FINAL_CHECKPOINT, st.q, st.aux, st.t,
                                    st.step)
            else:
                cp.write_checkpoint(SETTINGS.checkpoint_dir, sc.name,
                                    FINAL_CHECKPOINT, sc.q, sc.aux, sc.t0, 0)
        raise
    sc.q, sc.aux = state.q, state.aux
    engf = float(norm(sc.dg.grid, state.q))
    logger.info("finished: norm(Q) = %.16e  ratio %.16e", engf,
                engf / eng0 if eng0 else float("nan"))
    if SETTINGS.checkpoint_at_end:
        cp.write_checkpoint(SETTINGS.checkpoint_dir, sc.name,
                            FINAL_CHECKPOINT, state.q, state.aux, state.t,
                            state.step)
    return engf / eng0 if eng0 else float("nan")
