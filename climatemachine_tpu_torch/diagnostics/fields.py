"""Derived diagnostic fields that need DG derivatives, and the
AtmosGCMDefault group (port of ``climatemachine_tpu/diagnostics/
fields.py``: ``vector_gradients``, ``vorticity``,
``atmos_gcm_default_vars``, ``AtmosGCMDefaultGroup``).  The gradients
are the DG operator's central-flux ones (``DGModel.dg_gradient_of``):
plain torch, no kernel."""

from __future__ import annotations

import numpy as np
import torch

from climatemachine_tpu_torch.diagnostics.machine import (DiagnosticsGroup,
                                                          PointwiseDiagnostic)
from climatemachine_tpu_torch.dg.spatial import strong_gradient
from climatemachine_tpu_torch.mesh.interpolation import project_cubed_sphere
from climatemachine_tpu_torch.physics import thermodynamics as td


def vector_gradients(dg, u):
    """The face-corrected DG gradient of a vector field: u ``[E, 3, Np]``
    → G ``[E, 3, 3, Np]`` with G[:, j, k] = ∂u_k/∂x_j."""
    return dg.dg_gradient_of(u, direction="every")


def _curl(G):
    """∇×u ``[E, 3, Np]`` of G[:, j, k] = ∂u_k/∂x_j."""
    return torch.stack([G[:, 1, 2] - G[:, 2, 1],
                        G[:, 2, 0] - G[:, 0, 2],
                        G[:, 0, 1] - G[:, 1, 0]], dim=1)


def vorticity(dg, u):
    """The relative vorticity ∇×u ``[E, 3, Np]`` of u ``[E, 3, Np]``."""
    return _curl(vector_gradients(dg, u))


def atmos_gcm_default_vars(model, dg):
    """The "AtmosGCMDefault" variables: u/v/w, rho, temp, pres, thd, et,
    ei, ht, hi, vort, vort2 and, with prognostic moisture, qt, ql, qv,
    qi, thv, thl.  Velocities are Cartesian on the DG grid; the group
    projects them to (zonal, meridional, radial) after interpolation."""
    ps = model.param_set

    def rho_(m, q, aux, g):
        return m.prog_spec.get(q, "rho")

    def u_(i):
        def f(m, q, aux, g):
            return m.prog_spec.get(q, "rhou")[:, i] / m.prog_spec.get(q,
                                                                      "rho")
        return f

    def thermo_scalar(fn):
        def f(m, q, aux, g):
            T, p, u, pp = m.thermo_full(q, aux)
            return fn(m, q, T, p, pp)
        return f

    def e_tot(m, q):
        return m.prog_spec.get(q, "rhoe") / m.prog_spec.get(q, "rho")

    out = [
        PointwiseDiagnostic("u", u_(0), "m/s"),
        PointwiseDiagnostic("v", u_(1), "m/s"),
        PointwiseDiagnostic("w", u_(2), "m/s"),
        PointwiseDiagnostic("rho", rho_, "kg/m^3"),
        PointwiseDiagnostic("temp", thermo_scalar(
            lambda m, q, T, p, pp: T), "K"),
        PointwiseDiagnostic("pres", thermo_scalar(
            lambda m, q, T, p, pp: p), "Pa"),
        PointwiseDiagnostic("thd", thermo_scalar(
            lambda m, q, T, p, pp: td.dry_pottemp(ps, T, p, pp)), "K"),
        PointwiseDiagnostic("et", thermo_scalar(
            lambda m, q, T, p, pp: e_tot(m, q)), "J/kg"),
        PointwiseDiagnostic("ei", thermo_scalar(
            lambda m, q, T, p, pp: td.internal_energy(ps, T, pp)), "J/kg"),
        PointwiseDiagnostic("ht", thermo_scalar(
            lambda m, q, T, p, pp: td.total_specific_enthalpy(
                ps, e_tot(m, q), T, pp)), "J/kg"),
        PointwiseDiagnostic("hi", thermo_scalar(
            lambda m, q, T, p, pp: td.total_specific_enthalpy(
                ps, td.internal_energy(ps, T, pp), T, pp)), "J/kg"),
    ]

    # two vorticity estimates, as the reference emits vort and vort2: the
    # face-corrected DG gradient and the element-local strong gradient
    def velocity(m, q):
        return m.prog_spec.get(q, "rhou") / m.prog_spec.get(q, "rho")[:,
                                                                      None]

    def vort(m, q, aux, g):
        w = vorticity(dg, velocity(m, q))
        return torch.sum(w * m.vertical_unit(aux), dim=1)

    def vort2(m, q, aux, g):
        G = strong_gradient(dg.grid, velocity(m, q), (0, 1, 2))
        return torch.sum(_curl(G) * m.vertical_unit(aux), dim=1)

    out += [PointwiseDiagnostic("vort", vort, "1/s"),
            PointwiseDiagnostic("vort2", vort2, "1/s")]

    if model.physics.moisture.vars_prognostic().num:
        def moist_scalar(fn):
            def f(m, q, aux, g):
                T, p, u, pp = m.thermo_full(q, aux)
                return fn(T, p, pp)
            return f

        out += [
            PointwiseDiagnostic("qt", moist_scalar(
                lambda T, p, pp: pp.tot), "kg/kg"),
            PointwiseDiagnostic("ql", moist_scalar(
                lambda T, p, pp: pp.liq), "kg/kg"),
            PointwiseDiagnostic("qv", moist_scalar(
                lambda T, p, pp: pp.tot - pp.liq - pp.ice), "kg/kg"),
            PointwiseDiagnostic("qi", moist_scalar(
                lambda T, p, pp: pp.ice), "kg/kg"),
            PointwiseDiagnostic("thv", moist_scalar(
                lambda T, p, pp: td.virtual_pottemp(ps, T, p, pp)), "K"),
            PointwiseDiagnostic("thl", moist_scalar(
                lambda T, p, pp: td.liquid_ice_pottemp(ps, T, p, pp)), "K"),
        ]
    return out


class AtmosGCMDefaultGroup(DiagnosticsGroup):
    """The "AtmosGCMDefault" group on the lat-lon-level grid of
    ``interpolator`` (an ``InterpolationCubedSphere``): the full
    variable set, the velocities projected to (zonal, meridional,
    radial) after interpolation, on the host."""

    def __init__(self, dg, interpolator, writer=None, out_path=None):
        super().__init__("AtmosGCMDefault", dg.balance_law, dg.grid,
                         atmos_gcm_default_vars(dg.balance_law, dg),
                         writer=writer, out_path=out_path,
                         interpolator=interpolator)

    def collect(self, q, aux):
        vals = super().collect(q, aux)
        itp = self.interpolator
        if itp is not None and hasattr(itp, "latlon"):
            lats, lons, _ = itp.latlon
            sph = project_cubed_sphere((lats, lons), np.stack(
                [vals["u"], vals["v"], vals["w"]], axis=-1))
            vals["u"], vals["v"], vals["w"] = (sph[..., 0], sph[..., 1],
                                               sph[..., 2])
        return vals
