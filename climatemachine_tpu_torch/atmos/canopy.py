"""Canopy-atmosphere sources after Patton et al. (2016) (port of
``climatemachine_tpu/atmos/canopy.py``: ``CanopyAerodynamics`` :34 and
``CanopyAtmoInteraction`` :62).

Both act inside the canopy layer z ≤ h_c only, with the leaf area
density LAD = LAI / h_c: the vegetation's form drag −c_d LAD |u| ρu on
momentum and, with the SGS TKE model, −8/3 c_d LAD |u| ρe_SGS on the
TKE; transpiration G_veg LAD (1 − RH) ρ into the total water and the
uptake −GPP LAD of every tracer.  They run on the generic DG operator
(``on_var_major_rhs`` False, as the JAX package's have no var-major
form).  Var-major: scalars ``[E, Np]``, vectors ``[E, 3, Np]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from climatemachine_tpu_torch.atmos.sources import Source
from climatemachine_tpu_torch.physics import thermodynamics as td


def _canopy_mask(model, ctx, h_c):
    """1 inside the canopy (z ≤ h_c), 0 above."""
    z = ctx.aux("orientation.Phi") / model.param_set.grav
    return (z <= h_c).to(z.dtype)


@dataclass(frozen=True)
class CanopyAerodynamics(Source):
    """Form drag −c_d LAD |u| ρu and, with ``sgstke``, the TKE's
    −8/3 c_d LAD |u| ρe_SGS."""
    c_d: float          # drag coefficient
    h_c: float          # canopy height [m]
    LAI: float          # leaf area index
    dz: float = 0.0     # grid spacing (unused, as in the JAX package)
    on_var_major_rhs = False

    def contributions_vm(self, model, ctx, t):
        LAD = self.LAI / self.h_c
        u_mag = torch.linalg.vector_norm(ctx.rhou / ctx.rho[:, None], dim=1)
        coef = self.c_d * LAD * _canopy_mask(model, ctx, self.h_c) * u_mag
        out = {"rhou": -coef[:, None] * ctx.rhou}
        if model.physics.sgstke is not None:
            out["sgstke.rhoe_SGS"] = -(8.0 / 3.0) * coef * \
                model.prog_spec.get(ctx.q, "sgstke.rhoe_SGS")
        return out


@dataclass(frozen=True)
class CanopyAtmoInteraction(Source):
    """Transpiration G_veg LAD (1 − RH) ρ into ρq_tot (with a moist model)
    and the uptake −GPP LAD of each tracer."""
    h_c: float          # canopy height [m]
    LAI: float          # leaf area index
    dz: float = 0.0     # grid spacing (unused, as in the JAX package)
    G_veg: float = 0.0  # canopy conductance [m/s]
    GPP: float = 0.0    # gross primary production (tracer sink rate)
    on_var_major_rhs = False

    def contributions_vm(self, model, ctx, t):
        LAD = self.LAI / self.h_c
        mask = _canopy_mask(model, ctx, self.h_c)
        out = {}
        if any(n.startswith("moisture.")
               for n in model.prog_spec.flattened_names()):
            RH = td.relative_humidity(model.param_set, ctx.T, ctx.p, ctx.pp)
            out["moisture.rhoq_tot"] = self.G_veg * LAD * mask * (
                (1.0 - RH) * ctx.rho)
        if model.tracers.N > 0:
            sink = -(self.GPP * LAD) * mask
            out["tracers.rhochi"] = sink[:, None].expand(
                -1, model.tracers.N, -1)
        return out
