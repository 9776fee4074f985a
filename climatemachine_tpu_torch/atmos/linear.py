"""Linearized acoustic(-gravity) models, the IMEX implicit operators
(port of ``climatemachine_tpu/atmos/linear.py`` :1-121).

Linear balance laws about the hydrostatic reference state: mass is
advected by ρu, momentum feels the linearized pressure
p_L = ρ R_d T_0 + R_d/cv_d (ρe − ρΦ), energy is carried with the
reference enthalpy.  Run by the generic DG operator with
``direction="vertical"`` they form the HEVI implicit operator, local to
each column of a stacked grid.

Var-major: state ``[E, n, L]`` and aux ``[E, naux, L]`` over L nodes
(volume or face lanes), flux ``[E, 3, n, L]`` (direction i, variable);
n = 5, or more with moisture, precipitation and tracers, whose lanes have
no linear flux and no linear source (JAX ``linear.py`` :55-66).
"""

from __future__ import annotations

import torch

from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.utils.variables import VarSpec


class AtmosLinearModel:
    """Shares the prognostic and aux schemas of the AtmosModel ``atmos``
    and its walls; has no gradient or hyperdiffusive state and never
    touches aux."""

    gradlap_spec = VarSpec()

    def __init__(self, atmos):
        self.atmos = atmos
        self.prog_spec = atmos.prog_spec
        self.aux_spec = atmos.aux_spec

    @property
    def param_set(self):
        return self.atmos.param_set

    def linearized_pressure(self, q, aux):
        """p_L = ρ R_d T_0 + R_d/cv_d (ρe − ρΦ) (dry)."""
        ps, sp = self.param_set, self.prog_spec
        rho, rhoe = sp.get(q, "rho"), sp.get(q, "rhoe")
        Phi = self.aux_spec.get(aux, "orientation.Phi")
        return rho * ps.R_d * ps.T_0 + ps.R_d / ps.cv_d * (rhoe - rho * Phi)

    def flux_first_order(self, q, aux, t):
        sp = self.prog_spec
        rhou = sp.get(q, "rhou")                          # [E, 3, L]
        pL = self.linearized_pressure(q, aux)
        E, n, L = q.shape
        F = torch.zeros((E, 3, n, L), dtype=q.dtype, device=q.device)
        F[:, :, sp.index("rho").start] = rhou
        i_u = sp.index("rhou").start
        for i in range(3):
            F[:, i, i_u + i] = pL
        F[:, :, sp.index("rhoe").start] = self._energy_coeff(aux)[:, None] \
            * rhou
        return F

    def _energy_coeff(self, aux):
        raise NotImplementedError

    def _ref_enthalpy(self, aux):
        """(ρe_ref + p_ref)/ρ_ref."""
        get = lambda name: self.aux_spec.get(aux, f"ref_state.{name}")
        return (get("rhoe") + get("p")) / get("rho")

    def wavespeed(self, nrm, q, aux, t):
        """The sound speed of the reference temperature, ``[E, L]``."""
        T_ref = self.aux_spec.get(aux, "ref_state.T")
        return td.soundspeed_air(self.param_set, T_ref)

    def nondiffusive_courant(self, q, aux, dt, delta_x, direction="every"):
        """c dt / Δx per node with c the reference state's sound speed
        (the model has no flow speed, in any direction), as the
        reference's linear model gives it; the JAX package's linear model
        has no thermo and its Courant number raises."""
        return self.wavespeed(None, q, aux, 0.0) * dt / delta_x

    def boundary_state(self, tag, nrm, q_minus, aux_minus, t):
        return self.atmos.boundary_state(tag, nrm, q_minus, aux_minus, t)

    def update_auxiliary_state(self, q, aux, grid):
        return aux


class AtmosAcousticLinearModel(AtmosLinearModel):
    """Acoustic only: energy coefficient (ρe_ref + p_ref)/ρ_ref − Φ and no
    gravity source."""

    def _energy_coeff(self, aux):
        return self._ref_enthalpy(aux) - self.aux_spec.get(aux,
                                                           "orientation.Phi")

    def source(self, q, aux, t):
        return torch.zeros_like(q)


class AtmosAcousticGravityLinearModel(AtmosLinearModel):
    """Acoustic and gravity: energy coefficient (ρe_ref + p_ref)/ρ_ref and
    the momentum source −ρ∇Φ."""

    def _energy_coeff(self, aux):
        return self._ref_enthalpy(aux)

    def source(self, q, aux, t):
        sp = self.prog_spec
        out = torch.zeros_like(q)
        out[:, sp.index("rhou")] = -sp.get(q, "rho")[:, None] \
            * self.aux_spec.get(aux, "orientation.grad_Phi")
        return out
