"""Passive tracers (port of ``climatemachine_tpu/atmos/tracers.py``:
``NoTracers`` :17, ``NTracers`` :40).

N advected scalars ρχ, prognostic lanes ``tracers.rhochi`` after the
moisture and precipitation lanes.  Their first-order flux ρχ u is the
model's (atmos/model.py); the second-order hooks below are those of a
turbulence closure's chain (gradient χ, gradient flux ∇χ and the
diffusive flux −ρ D_t δ_χ ∇χ), which no ported path runs yet.

Var-major: state ``[E, n, L]``, gradient argument ``[E, ngrad, L]``,
its gradient ``[E, 3, ngrad, L]`` (direction i, then variable), gradient
flux ``[E, ngf, L]`` with ``d_chi`` on 3·N lanes in (i, tracer) order,
the flux ``[E, 3, n, L]`` and the diffusivity D_t ``[E, 3, L]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from climatemachine_tpu_torch.utils.variables import VarSpec


class NoTracers:
    N = 0

    def vars_prognostic(self) -> VarSpec:
        return VarSpec()

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


@dataclass
class NTracers(NoTracers):
    """``delta_chi``: each tracer's diffusivity over the turbulent one."""
    delta_chi: Tuple[float, ...] = (1.0,)

    @property
    def N(self):
        return len(self.delta_chi)

    def vars_prognostic(self) -> VarSpec:
        # (N,), not N: one tracer still takes a vector slot
        return VarSpec(rhochi=(self.N,))

    def vars_gradient(self) -> VarSpec:
        return VarSpec(chi=(self.N,))

    def vars_gradient_flux(self) -> VarSpec:
        return VarSpec(d_chi=(3, self.N))

    def gradient_argument(self, model, q, aux, t, out):
        """χ = ρχ/ρ into ``tracers.chi`` of ``out``."""
        sp = model.prog_spec
        out = out.clone()
        out[:, model.grad_spec.index("tracers.chi")] = \
            sp.get(q, "tracers.rhochi") / sp.get(q, "rho")[:, None]
        return out

    def gradient_flux(self, model, grad_g, q, aux, t, out):
        """∇χ into ``tracers.d_chi`` of ``out``."""
        g = grad_g[:, :, model.grad_spec.index("tracers.chi")]
        out = out.clone()
        out[:, model.gf_spec.index("tracers.d_chi")] = g.reshape(
            g.shape[0], 3 * self.N, g.shape[-1])
        return out

    def flux_second_order(self, model, q, gf, aux, D_t, F):
        """Adds −ρ D_t,i δ_χ ∂_iχ to F[ρχ] (in place) and returns F."""
        rho = model.prog_spec.get(q, "rho")
        d_chi = model.gf_spec.get(gf, "tracers.d_chi")
        d_chi = d_chi.reshape(d_chi.shape[0], 3, self.N, d_chi.shape[-1])
        delta = torch.as_tensor(self.delta_chi, dtype=q.dtype,
                                device=q.device)
        F[:, :, model.prog_spec.index("tracers.rhochi")] -= (
            rho[:, None, None] * D_t[:, :, None] * delta[:, None] * d_chi)
        return F
