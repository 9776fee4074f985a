"""The remaining standard diagnostics groups (port of
``climatemachine_tpu/diagnostics/groups_extra.py``):

- ``AtmosMassEnergyLossGroup``: the relative drift of total mass and
  total energy since the first write (``dg/reductions.py``
  ``weightedsum``);
- ``AtmosTurbulenceStatsGroup``: the volume-averaged dimensionless
  kinetic energy E_k and its dissipation rate dE;
- ``AtmosRefStatePerturbationsGroup``: pointwise ρ, p, T, e_tot (and
  q_tot) perturbations from the hydrostatic reference state, on an
  interpolated grid;
- ``AtmosLESSpectraGroup`` / ``AtmosGCMSpectraGroup``: kinetic-energy
  power spectra on interpolated grids (``common/spectra.py``, on the
  host);
- ``DumpGroup``: raw dumps of the state, the aux or the tendencies.

Collects run on the state's device; their values reach the host in one
copy a write.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from climatemachine_tpu_torch.common.spectra import (gaussian_latitudes,
                                                     legendre_table,
                                                     power_spectrum_1d,
                                                     power_spectrum_2d,
                                                     power_spectrum_3d)
from climatemachine_tpu_torch.dg.reductions import weightedsum
from climatemachine_tpu_torch.diagnostics.machine import OutputGroup, to_host
from climatemachine_tpu_torch.mesh.interpolation import project_cubed_sphere


def _interp_dims(itp):
    """The writer's dimensions of an interpolator's target grid."""
    if hasattr(itp, "latlon"):
        lats, lons, rads = itp.latlon
        return {"lat": np.asarray(lats), "long": np.asarray(lons),
                "level": np.asarray(rads)}
    return {d: np.asarray(v) for d, v in zip(("x", "y", "z"), itp.xyz)}


class _ScalarGroup(OutputGroup):
    """A group whose every variable lies on the same dimensions
    (``_dims``; none by default): a subclass gives ``_collect_impl`` (on
    the device) and, where it needs it, ``_post`` (on the host)."""

    name = "Scalars"

    def __init__(self, dg, writer=None, out_path: Optional[str] = None):
        self.dg = dg
        self.model = dg.balance_law
        self.grid = dg.grid
        self.writer = writer
        self.out_path = out_path

    def collect(self, q, aux, t=0.0):
        return to_host(self._collect_impl(q, aux, t))

    def _dims(self):
        return {}

    def _layout(self, vals):
        dims = self._dims()
        return dims, {k: (tuple(dims), np.float64) for k in vals}


class AtmosMassEnergyLossGroup(_ScalarGroup):
    """The relative mass and energy drift since the first write:
    (S − S₀)/S₀ with S the weighted sum of ρ and of ρe."""

    name = "AtmosMassEnergyLoss"

    def __init__(self, dg, writer=None, out_path=None):
        super().__init__(dg, writer, out_path)
        self._sum0 = None

    def _collect_impl(self, q, aux, t):
        s = self.model.prog_spec
        return {"mass": weightedsum(self.grid, q, s.index("rho").start),
                "energy": weightedsum(self.grid, q, s.index("rhoe").start)}

    def _post(self, vals):
        if self._sum0 is None:
            self._sum0 = dict(vals)
        return {"delta_mass":
                (vals["mass"] - self._sum0["mass"]) / self._sum0["mass"],
                "delta_energy": (vals["energy"] - self._sum0["energy"])
                / self._sum0["energy"]}


class AtmosTurbulenceStatsGroup(_ScalarGroup):
    """The volume-averaged dimensionless kinetic energy E_k = ⟨|u/nor|²⟩/2
    and its dissipation dE = (E_k,prev − E_k)/iter."""

    name = "AtmosTurbulenceStats"

    def __init__(self, dg, nor: float, iter_: float, writer=None,
                 out_path=None):
        super().__init__(dg, writer, out_path)
        self.nor = nor
        self.iter = iter_
        self._prev = None

    def _collect_impl(self, q, aux, t):
        sp, M = self.model.prog_spec, self.grid.M
        u = sp.get(q, "rhou") / sp.get(q, "rho")[:, None] / self.nor
        ke = 0.5 * torch.sum(u * u, dim=1)
        return {"E_k": torch.sum(M * ke) / torch.sum(M)}

    def _post(self, vals):
        ek = vals["E_k"]
        de = 0.0 if self._prev is None else (self._prev - ek) / self.iter
        self._prev = ek
        return {"E_k": ek, "dE": np.float64(de)}


class AtmosRefStatePerturbationsGroup(_ScalarGroup):
    """Pointwise perturbations of ρ, p, T, e_tot (and q_tot with
    moisture) from the hydrostatic reference state, on the grid of
    ``interpolator``."""

    name = "AtmosRefStatePerturbations"

    def __init__(self, dg, interpolator, writer=None, out_path=None):
        self.interpolator = interpolator
        super().__init__(dg, writer, out_path)

    def _collect_impl(self, q, aux, t):
        bl = self.model
        a, sp = bl.aux_spec, bl.prog_spec
        rho = sp.get(q, "rho")
        T, p, _, pp = bl.thermo_full(q, aux)
        out = {
            "rho": rho - a.get(aux, "ref_state.rho"),
            "pres": p - a.get(aux, "ref_state.p"),
            "temp": T - a.get(aux, "ref_state.T"),
            "et": (sp.get(q, "rhoe") - a.get(aux, "ref_state.rhoe")) / rho,
        }
        if pp is not None:
            try:
                qt_ref = (a.get(aux, "ref_state.rhoq_tot")
                          / a.get(aux, "ref_state.rho"))
            except KeyError:
                qt_ref = torch.zeros_like(rho)
            out["qt"] = pp.tot - qt_ref
        return {k: self.interpolator(v) for k, v in out.items()}

    def _dims(self):
        return _interp_dims(self.interpolator)


class _SpectraGroup(OutputGroup):
    """A spectra group: the velocity interpolated on the device, copied
    to the host once, the spectrum there (a subclass gives ``collect``
    and ``_layout``)."""

    def __init__(self, dg, interpolator, writer=None, out_path=None):
        self.dg = dg
        self.model = dg.balance_law
        self.interpolator = interpolator
        self.writer = writer
        self.out_path = out_path

    def _velocity(self, q):
        sp = self.model.prog_spec
        u = sp.get(q, "rhou") / sp.get(q, "rho")[:, None]
        return to_host({c: self.interpolator(u[:, i])
                        for i, c in enumerate("uvw")})


class AtmosLESSpectraGroup(_SpectraGroup):
    """The 3-D kinetic-energy power spectrum on an interpolated
    equispaced box ("spectrum" on the k dimension)."""

    name = "AtmosLESSpectra"

    def __init__(self, dg, interpolator, L: float, nor: float = 1.0,
                 writer=None, out_path=None):
        super().__init__(dg, interpolator, writer, out_path)
        self.L = L
        self.nor = nor

    def collect(self, q, aux=None, t=0.0):
        vel = self._velocity(q)
        u, v, w = (vel[c] / self.nor for c in "uvw")
        k, spec = power_spectrum_3d(u, v, w, self.L)
        return {"k": k, "spectrum": spec}

    def _layout(self, vals):
        return {"k": vals["k"]}, {"spectrum": (("k",), np.float64)}


class AtmosGCMSpectraGroup(_SpectraGroup):
    """The zonal kinetic-energy spectrum on an interpolated lat-lon-level
    grid ("spectrum_1d" of ½(u² + v²) per zonal wavenumber,
    latitude-weighted); on Gauss-Legendre latitudes
    (``spectra.gaussian_lats_deg``) also the spherical-harmonic spectrum
    "spectrum_2d" ``[m, n, level]``."""

    name = "AtmosGCMSpectra"

    def __init__(self, dg, interpolator, writer=None, out_path=None):
        super().__init__(dg, interpolator, writer, out_path)
        lats, lons, rads = interpolator.latlon
        self.lats, self.lons, self.rads = (np.asarray(lats),
                                           np.asarray(lons),
                                           np.asarray(rads))
        sin_g, w_g = gaussian_latitudes(len(self.lats))
        self._sph = None
        if np.allclose(np.sin(np.deg2rad(self.lats)), sin_g, atol=1e-8):
            num_four = max((len(self.lons) - 1) // 2, 1)
            num_sph = min(len(self.lats) - 1, 2 * num_four)
            self._sph = (legendre_table(num_four, num_sph, sin_g), w_g)

    def collect(self, q, aux, t=0.0):
        vel = self._velocity(q)
        vec = np.stack([vel[c] for c in "uvw"], axis=-1)  # [lat, lon, lev, 3]
        sph = project_cubed_sphere((self.lats, self.lons), vec)
        ke = 0.5 * (sph[..., 0] ** 2 + sph[..., 1] ** 2)
        w = np.cos(np.deg2rad(self.lats))
        out = {"spectrum_1d": power_spectrum_1d(ke, lat_weights=w)}
        if self._sph is not None:
            P, w_g = self._sph
            # [lat, lon, lev] -> [lon, lat, lev] for the transform
            out["spectrum_2d"] = power_spectrum_2d(np.moveaxis(ke, 0, 1), P,
                                                   w_g)
        return out

    def _layout(self, vals):
        nk = vals["spectrum_1d"].shape[0]
        dims = {"k": np.arange(1, nk + 1, dtype=np.float64),
                "level": self.rads}
        varspec = {"spectrum_1d": (("k", "level"), np.float64)}
        if "spectrum_2d" in vals:
            m, n = vals["spectrum_2d"].shape[:2]
            dims["m"] = np.arange(m, dtype=np.float64)
            dims["n"] = np.arange(n, dtype=np.float64)
            varspec["spectrum_2d"] = (("m", "n", "level"), np.float64)
        return dims, varspec


class DumpGroup(_ScalarGroup):
    """A raw dump of every lane, optionally interpolated: ``which`` is
    'state' (prognostic), 'aux', or 'tendencies' (the DG operator's
    tendency of each prognostic variable)."""

    def __init__(self, dg, which: str = "state", interpolator=None,
                 writer=None, out_path=None):
        self.which = which
        self.interpolator = interpolator
        self.name = "Dump" + which.capitalize()
        super().__init__(dg, writer, out_path)

    def _collect_impl(self, q, aux, t):
        bl = self.model
        spec = bl.aux_spec if self.which == "aux" else bl.prog_spec
        if self.which == "state":
            arr = q
        elif self.which == "aux":
            arr = aux
        else:
            arr, _ = self.dg(q, aux, t)
        out = {}
        for i, nm in enumerate(spec.flattened_names()):
            key = nm.replace(".", "_").replace("[", "_").rstrip("]")
            if self.which == "tendencies":
                key = "tend_" + key
            f = arr[:, i]
            out[key] = (self.interpolator(f) if self.interpolator is not None
                        else f)
        return out

    def _dims(self):
        if self.interpolator is None:
            return {"elem": np.arange(self.grid.nelem, dtype=np.float64),
                    "node": np.arange(self.grid.Np, dtype=np.float64)}
        return _interp_dims(self.interpolator)
