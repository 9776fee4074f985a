"""The diagnostics engine: declared variables → collect → reduce → write
(port of ``climatemachine_tpu/diagnostics/machine.py``:
``PointwiseDiagnostic``, ``HorizontalAverage``, ``horizontal_average``,
``DiagnosticsGroup``, ``atmos_default_vars``, ``atmos_les_profiles``).

A group's collect is plain torch on the state's device (the JAX
package jits it); its values reach the host in one copy a write
(:func:`to_host`), for the writer.  State and aux are var-major ``[E,
n, Np]``; a variable's function gives nodal values ``[E, Np]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence

import numpy as np
import torch


@dataclass
class PointwiseDiagnostic:
    """fn(model, q, aux, grid) → ``[E, Np]`` nodal values."""
    name: str
    fn: Callable
    units: str = ""


@dataclass
class HorizontalAverage:
    """The M-weighted horizontal average per vertical level of fn's
    nodal values: ``[n_vert · Nq3]``."""
    name: str
    fn: Callable
    units: str = ""


def horizontal_average(grid, f):
    """``[E, Np]`` → ``[n_vert · Nq3]``, the M-weighted average per
    level."""
    Nq1, Nq2, Nq3 = grid.Nq
    nv, nh = grid.n_vert, grid.n_horz
    fs = f.reshape(nh, nv, Nq3, Nq2 * Nq1)
    Ms = grid.M.reshape(nh, nv, Nq3, Nq2 * Nq1)
    num = torch.sum(fs * Ms, dim=(0, 3))
    den = torch.sum(Ms, dim=(0, 3))
    return (num / den).reshape(nv * Nq3)


def to_host(vals: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{name: tensor} → {name: numpy array} of the same shapes, in one
    copy from the device (the tensors flattened into one, in their
    common dtype)."""
    if not vals:
        return {}
    ts = list(vals.values())
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    flat = torch.cat([t.reshape(-1).to(dtype) for t in ts]).cpu().numpy()
    out, s = {}, 0
    for k, t in vals.items():
        out[k] = flat[s:s + t.numel()].reshape(tuple(t.shape))
        s += t.numel()
    return out


def every_steps_callback(write, every_steps: int):
    """A driver callback calling ``write(q, aux, t)`` on the solve state
    every ``every_steps`` steps (``state.aux``: the aux of the current
    state, its deferred lanes refreshed)."""
    from climatemachine_tpu_torch.driver.callbacks import \
        EveryXSimulationSteps

    def fn(state):
        write(state.q, state.aux, state.t)

    return EveryXSimulationSteps(fn, every_steps)


class OutputGroup:
    """A group whose ``write(q, aux, t)`` collects its values
    (``collect``), finishes them on the host (``_post``) and hands the
    writer the variables of ``_layout(vals)`` = (dimensions, {name:
    (dimension names, dtype)}), opening the file at the first write;
    without a writer it returns the values alone."""
    writer = None
    out_path = None
    _initialized = False

    def _post(self, vals):
        return vals

    def write(self, q, aux, t):
        vals = self._post(self.collect(q, aux, t))
        if self.writer is None:
            return vals
        dims, varspec = self._layout(vals)
        if not self._initialized:
            self.writer.init_data(self.out_path, dims, varspec)
            self._initialized = True
        self.writer.append_data(self.out_path,
                                {k: vals[k] for k in varspec}, t)
        return vals

    def make_callback(self, every_steps: int):
        return every_steps_callback(self.write, every_steps)


class DiagnosticsGroup:
    """A named set of diagnostic variables collected on an interval and
    written out; ``interpolator``, an interpolator of
    :mod:`climatemachine_tpu_torch.mesh.interpolation`, maps pointwise
    fields onto its grid before they are written."""

    def __init__(self, name: str, model, grid,
                 variables: Sequence, writer=None, out_path: str = None,
                 interpolator=None):
        self.name = name
        self.model = model
        self.grid = grid
        self.variables = list(variables)
        self.writer = writer
        self.out_path = out_path
        self.interpolator = interpolator
        self._initialized = False

    def collect(self, q, aux):
        """Each variable's values, computed on the state's device."""
        out = {}
        for var in self.variables:
            vals = var.fn(self.model, q, aux, self.grid)
            if isinstance(var, HorizontalAverage):
                out[var.name] = horizontal_average(self.grid, vals)
            elif self.interpolator is not None:
                out[var.name] = self.interpolator(vals)
            else:
                out[var.name] = vals
        return to_host(out)

    # --- writer integration -------------------------------------------------
    def _dims(self):
        dims = {}
        g = self.grid
        if self.interpolator is not None and hasattr(self.interpolator,
                                                     "latlon"):
            lats, lons, rads = self.interpolator.latlon
            dims = {"lat": np.asarray(lats), "lon": np.asarray(lons),
                    "level": np.asarray(rads)}
        elif any(isinstance(v, HorizontalAverage) for v in self.variables):
            dims["zlevel"] = np.arange(g.n_vert * g.Nq[2], dtype=np.float64)
        return dims

    def write(self, q, aux, t):
        vals = self.collect(q, aux)
        if self.writer is None:
            return vals
        if not self._initialized:
            dims = self._dims()
            vars_ = {}
            for var in self.variables:
                v = vals[var.name]
                if isinstance(var, HorizontalAverage):
                    vars_[var.name] = (("zlevel",), np.float64)
                elif self.interpolator is not None:
                    vars_[var.name] = (tuple(dims.keys()), np.float64)
                else:
                    # raw nodal dump: flatten to one dim
                    dims.setdefault("node", np.arange(v.size,
                                                      dtype=np.float64))
                    vars_[var.name] = (("node",), np.float64)
            self.writer.init_data(self.out_path, dims, vars_)
            self._initialized = True
        flat = {}
        for var in self.variables:
            v = vals[var.name]
            if (self.interpolator is None
                    and not isinstance(var, HorizontalAverage)):
                v = v.reshape(-1)
            flat[var.name] = v
        self.writer.append_data(self.out_path, flat, t)
        return vals

    def make_callback(self, every_steps: int):
        return every_steps_callback(self.write, every_steps)


# --- standard variable sets -------------------------------------------------

def atmos_default_vars(model):
    """The core of the AtmosLES/GCMDefault variables: ρ, u, v, w, T, p,
    θ_v and, with prognostic moisture, q_tot."""
    def rho(m, q, aux, g):
        return m.prog_spec.get(q, "rho")

    def u_(i):
        def f(m, q, aux, g):
            return m.prog_spec.get(q, "rhou")[:, i] / m.prog_spec.get(q,
                                                                      "rho")
        return f

    def temp(m, q, aux, g):
        return m.thermo(q, aux)[0]

    def pres(m, q, aux, g):
        return m.thermo(q, aux)[1]

    def thetav(m, q, aux, g):
        ps = m.param_set
        T, p = m.thermo(q, aux)
        return T * (ps.MSLP / p) ** ps.kappa_d

    out = [
        PointwiseDiagnostic("rho", rho, "kg/m^3"),
        PointwiseDiagnostic("u", u_(0), "m/s"),
        PointwiseDiagnostic("v", u_(1), "m/s"),
        PointwiseDiagnostic("w", u_(2), "m/s"),
        PointwiseDiagnostic("temp", temp, "K"),
        PointwiseDiagnostic("pres", pres, "Pa"),
        PointwiseDiagnostic("thv", thetav, "K"),
    ]
    if model.physics.moisture.vars_prognostic().num:
        def qt(m, q, aux, g):
            return (m.prog_spec.get(q, "moisture.rhoq_tot")
                    / m.prog_spec.get(q, "rho"))
        out.append(PointwiseDiagnostic("qt", qt, "kg/kg"))
    return out


def atmos_les_profiles(model):
    """Horizontal-average profiles of :func:`atmos_default_vars`."""
    pw = atmos_default_vars(model)
    return [HorizontalAverage(v.name + "_avg", v.fn, v.units) for v in pw]
