"""Moisture models (port of ``climatemachine_tpu/atmos/moisture.py``:
``MoistureModel`` with its gradient hooks :24-53, ``DryModel``,
``EquilMoist`` with its gradient hooks and diffusive flux :103-160,
``NonEquilMoist`` :174-213).

A moisture model names its prognostic and aux lanes, refreshes the aux
lanes from the state (``update_aux``) and gives the model's thermo
(``thermo``: T, p and the phase partition).  ``DryModel`` caches θ_v and
T; ``EquilMoist`` adds ρq_tot and caches T, θ_v, q_liq and q_ice, with T
from the saturation adjustment.  Under a turbulence closure
``EquilMoist`` adds q_tot to the gradient arguments, ∇q_tot to the
gradient flux and −ρ D_t ∇q_tot to the fluxes of ρq_tot and ρ (and its
u-weighted part to ρu); the dry model adds nothing.  ``NonEquilMoist``
carries ρq_tot, ρq_liq and ρq_ice, caches T and θ_v, and, as in the JAX
package, adds no gradient lanes (its water is advected, not diffused).
State and aux are var-major ``[E, n, L]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.utils.variables import VarSpec


def _internal_energy(model, q, aux):
    """e_int = ρe/ρ − |ρu|²/2ρ² − Φ of the conserved state."""
    sp = model.prog_spec
    rho, rhou, rhoe = sp.get(q, "rho"), sp.get(q, "rhou"), sp.get(q, "rhoe")
    ke = 0.5 * torch.sum(rhou * rhou, dim=1) / (rho * rho)
    return rhoe / rho - ke - model.aux_spec.get(aux, "orientation.Phi")


def _set(aux, spec, values: dict):
    out = aux.clone()
    for name, val in values.items():
        out[:, spec.index(name)] = val[:, None]
    return out


class MoistureModel:
    def vars_prognostic(self) -> VarSpec:
        return VarSpec()

    def vars_aux(self) -> VarSpec:
        return VarSpec()

    def update_aux(self, model, q, aux):
        return aux

    def thermo(self, model, q, aux):
        """(T, p, phase partition or None) from the state and aux."""
        raise NotImplementedError

    def vars_gradient(self) -> VarSpec:
        return VarSpec()

    def vars_gradient_flux(self) -> VarSpec:
        return VarSpec()

    def gradient_argument(self, model, q, aux, t, out):
        return out

    def gradient_flux(self, model, grad_g, q, aux, t, out):
        return out

    def flux_second_order(self, model, q, gf, aux, D_t, F):
        return F


class DryModel(MoistureModel):
    """Dry air; aux caches θ_v and T.  T and p in closed form from (ρ,
    ρθ) under ``ThetaModel``; p the reference pressure under
    ``Anelastic1D``."""

    def vars_aux(self) -> VarSpec:
        return VarSpec(theta_v=1, air_T=1)

    def thermo(self, model, q, aux):
        ps, sp, ph = model.param_set, model.prog_spec, model.physics
        rho = sp.get(q, "rho")
        if ph.energy.is_theta:
            T, p = ph.energy.thermo_dry(ps, rho, sp.get(q, "rhoe"))
            return T, p, None
        T = td.air_temperature(ps, _internal_energy(model, q, aux))
        if ph.compressibility.is_anelastic:
            return T, model.aux_spec.get(aux, "ref_state.p"), None
        return T, td.air_pressure(ps, T, rho), None

    def update_aux(self, model, q, aux):
        ps = model.param_set
        T, p, _ = self.thermo(model, q, aux)
        return _set(aux, model.aux_spec, {
            "moisture.air_T": T,
            "moisture.theta_v": T * (ps.MSLP / p) ** ps.kappa_d})


@dataclass
class EquilMoist(MoistureModel):
    """Equilibrium moisture by saturation adjustment (``maxiter`` Newton
    steps): prognostic ρq_tot; aux caches T, θ_v, q_liq and q_ice."""
    maxiter: int = 6

    def vars_prognostic(self) -> VarSpec:
        return VarSpec(rhoq_tot=1)

    def vars_aux(self) -> VarSpec:
        return VarSpec(temperature=1, theta_v=1, q_liq=1, q_ice=1)

    def vars_gradient(self) -> VarSpec:
        return VarSpec(q_tot=1)

    def vars_gradient_flux(self) -> VarSpec:
        return VarSpec(d_q_tot=3)

    def gradient_argument(self, model, q, aux, t, out):
        """q_tot into ``moisture.q_tot`` of ``out``."""
        sp = model.prog_spec
        out = out.clone()
        out[:, model.grad_spec.index("moisture.q_tot").start] = \
            sp.get(q, "moisture.rhoq_tot") / sp.get(q, "rho")
        return out

    def gradient_flux(self, model, grad_g, q, aux, t, out):
        """∇q_tot into ``moisture.d_q_tot`` of ``out``."""
        out = out.clone()
        out[:, model.gf_spec.index("moisture.d_q_tot")] = grad_g[
            :, :, model.grad_spec.index("moisture.q_tot").start]
        return out

    def flux_second_order(self, model, q, gf, aux, D_t, F):
        """Adds f = −ρ D_t ∇q_tot to F[ρq_tot] and F[ρ], and f u to F[ρu]
        (in place); returns F."""
        sp = model.prog_spec
        rho = sp.get(q, "rho")
        f_q = -rho[:, None] * D_t * model.gf_spec.get(gf, "moisture.d_q_tot")
        F[:, :, sp.index("moisture.rhoq_tot").start] += f_q
        F[:, :, sp.index("rho").start] += f_q
        F[:, :, sp.index("rhou")] += f_q[:, :, None] * (
            sp.get(q, "rhou") / rho[:, None])[:, None]
        return F

    def update_aux(self, model, q, aux):
        ps, sp = model.param_set, model.prog_spec
        rho = sp.get(q, "rho")
        q_tot = sp.get(q, "moisture.rhoq_tot") / rho
        T = td.saturation_adjustment(ps, _internal_energy(model, q, aux),
                                     rho, q_tot, n_iter=self.maxiter)
        pp = td.phase_partition_equil(ps, T, rho, q_tot)
        p = self._pressure(model, T, rho, pp, aux)
        theta_v = td.virtual_temperature(ps, T, pp) * \
            (ps.MSLP / p) ** ps.kappa_d
        return _set(aux, model.aux_spec, {
            "moisture.temperature": T, "moisture.theta_v": theta_v,
            "moisture.q_liq": pp.liq, "moisture.q_ice": pp.ice})

    @staticmethod
    def _pressure(model, T, rho, pp, aux):
        """p of the equation of state; the reference pressure under
        ``Anelastic1D`` (whose saturation adjustment runs at ρ = ρ_ref)."""
        if model.physics.compressibility.is_anelastic:
            return model.aux_spec.get(aux, "ref_state.p")
        return td.air_pressure(model.param_set, T, rho, pp)

    def thermo(self, model, q, aux):
        """T from the aux lane the last ``update_aux`` wrote."""
        ps, sp = model.param_set, model.prog_spec
        rho = sp.get(q, "rho")
        q_tot = sp.get(q, "moisture.rhoq_tot") / rho
        T = model.aux_spec.get(aux, "moisture.temperature")
        pp = td.phase_partition_equil(ps, T, rho, q_tot)
        return T, self._pressure(model, T, rho, pp, aux), pp


class NonEquilMoist(MoistureModel):
    """Prognostic ρq_tot, ρq_liq and ρq_ice; aux caches T (from e_int and
    the prognostic phase partition) and θ_v."""

    def vars_prognostic(self) -> VarSpec:
        return VarSpec(rhoq_tot=1, rhoq_liq=1, rhoq_ice=1)

    def vars_aux(self) -> VarSpec:
        return VarSpec(temperature=1, theta_v=1)

    def _phase(self, model, q):
        sp = model.prog_spec
        rho = sp.get(q, "rho")
        return td.PhasePartition(sp.get(q, "moisture.rhoq_tot") / rho,
                                 sp.get(q, "moisture.rhoq_liq") / rho,
                                 sp.get(q, "moisture.rhoq_ice") / rho)

    def update_aux(self, model, q, aux):
        ps = model.param_set
        rho = model.prog_spec.get(q, "rho")
        pp = self._phase(model, q)
        T = td.air_temperature(ps, _internal_energy(model, q, aux), pp)
        p = td.air_pressure(ps, T, rho, pp)
        theta_v = td.virtual_temperature(ps, T, pp) * \
            (ps.MSLP / p) ** ps.kappa_d
        return _set(aux, model.aux_spec, {"moisture.temperature": T,
                                          "moisture.theta_v": theta_v})

    def thermo(self, model, q, aux):
        """T from the aux lane the last ``update_aux`` wrote."""
        ps = model.param_set
        pp = self._phase(model, q)
        T = model.aux_spec.get(aux, "moisture.temperature")
        return T, td.air_pressure(ps, T, model.prog_spec.get(q, "rho"),
                                  pp), pp
