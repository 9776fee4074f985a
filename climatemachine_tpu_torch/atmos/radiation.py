"""Radiation models (port of ``climatemachine_tpu/atmos/radiation.py``:
``NoRadiation`` :26 and ``DYCOMSRadiationModel`` :34, the DYCOMS-II RF01
longwave model of Stevens et al. 2005, Eq. 3).

``DYCOMSRadiationModel`` adds the energy flux

    F_rad(z) = F₁ exp(−Q(0, z)) + F₀ exp(−Q(z, z_top))
             + ρ_i c_p D α_z ∛Δz_i (Δz_i/4 + z_i),  Δz_i = max(z − z_i, 0),

along the vertical unit vector to ρe's first-order flux, with Q(a, b) =
∫_a^b κ ρ q_liq dz the liquid-water attenuation paths.  The two paths
are the aux lanes ``radiation.int_att`` (upward from the ground) and
``radiation.int_att_rev`` (downward from the top), refreshed by the
model's ``update_auxiliary_state`` after the moisture lanes, as the
stack integrals of :class:`~climatemachine_tpu_torch.dg.columns.ColumnOps`
on the stacked grid.  torch has no ``cbrt``; Δz_i ≥ 0, so ``Δz_i ** (1/3)``
stands in for it, about an ulp from ``cbrt``.  Var-major: scalars ``[E,
L]``, the flux ``[E, 3, L]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from climatemachine_tpu_torch.utils.variables import VarSpec


class NoRadiation:
    """No radiation: no aux lanes, no flux."""

    def vars_aux(self) -> VarSpec:
        return VarSpec()


@dataclass
class DYCOMSRadiationModel:
    """The DYCOMS-II RF01 longwave model (module docstring)."""
    kappa: float = 85.0            # mass absorption coefficient [m²/kg]
    alpha_z: float = 1.0           # troposphere cooling parameter [m^-4/3]
    z_i: float = 840.0             # inversion height [m]
    rho_i: float = 1.13            # density at z_i [kg/m³]
    D_subsidence: float = 3.75e-6  # large-scale divergence [1/s]
    F_0: float = 70.0              # cloud-top flux [W/m²]
    F_1: float = 22.0              # surface flux [W/m²]

    def vars_aux(self) -> VarSpec:
        return VarSpec(int_att=1, int_att_rev=1)

    def integrand(self, model, q, aux):
        """κ ρ q_liq ``[E, L]``, q_liq prognostic (NonEquilMoist) or the
        moisture model's aux lane."""
        sp = model.prog_spec
        rho = sp.get(q, "rho")
        if "moisture.rhoq_liq" in sp.flattened_names():
            q_liq = sp.get(q, "moisture.rhoq_liq") / rho
        else:
            q_liq = model.aux_spec.get(aux, "moisture.q_liq")
        return rho * self.kappa * q_liq

    def update_aux_integrals(self, model, grid, q, aux):
        """Aux with both attenuation paths refreshed from (q, aux)."""
        ops = model.column_ops(grid)
        f = self.integrand(model, q, aux)[:, None]
        out = aux.clone()
        out[:, model.aux_spec.index("radiation.int_att")] = \
            ops.indefinite_integral(f)
        out[:, model.aux_spec.index("radiation.int_att_rev")] = \
            ops.reverse_indefinite_integral(f)
        return out

    def energy_flux(self, model, q, aux):
        """F_rad k̂ ``[E, 3, L]``, added to ρe's first-order flux."""
        ps, ap = model.param_set, model.aux_spec
        ori = model.physics.orientation
        z = ori.altitude(ps, ap.get(aux, "orientation.Phi"))
        dz_i = torch.clamp_min(z - self.z_i, 0.0)
        up = ap.get(aux, "radiation.int_att")
        dn = ap.get(aux, "radiation.int_att_rev")
        F_rad = (self.F_1 * torch.exp(-up) + self.F_0 * torch.exp(-dn)
                 + (self.rho_i * ps.cp_d * self.D_subsidence * self.alpha_z
                    * dz_i ** (1.0 / 3.0) * (dz_i / 4 + self.z_i)))
        zhat = ori.vertical_unit_vector(
            ps, ap.get(aux, "orientation.grad_Phi"))
        return F_rad[:, None] * zhat
