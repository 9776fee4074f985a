"""Horizontal biharmonic hyperdiffusion (port of
``climatemachine_tpu/atmos/hyperdiffusion.py`` ``DryBiharmonic`` :22-86:
``gradient_laplacian_argument`` :50, ``transform`` :64, ``flux`` :76;
and ``EquilMoistBiharmonic`` :90-123, its chain variable q_tot, ν₄_q,
its ``transform`` :110 and ``flux`` :117).

ν₄ = (Δ_h/2)⁴ / 2τ with Δ_h the horizontal grid lengthscale, an aux lane
filled once at set-up.  The LDG chain ∇→Δ→∇ runs on (u_h, h_tot); the
hyperdiffusive flux is F₂[ρu] = ρν₄∇Δu_h, F₂[ρe] = ν₄∇Δu_h·ρu +
ρν₄∇Δh_tot and, with moisture, F₂[ρq_tot] = ρν₄_q∇Δq_tot, ν₄_q =
(Δ_h/2)⁴ / 2τ_q.  The var-major RHS (dg/fast_rhs.py) builds it inside the
volume kernel and on the faces; the generic DG operator (dg/spatial.py)
through the ``transform`` and ``flux`` hooks, with the hyper state
ν₄∇Δ(u_h, h_tot) held ``[E, 3, 4, Np]`` (direction i, then variable),
and ν₄_q∇Δq_tot as a fifth variable with moisture.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from climatemachine_tpu_torch.utils.variables import VarSpec


@dataclass
class DryBiharmonic:
    """``tau_timescale``: hyperdiffusion timescale [s].  Horizontal only:
    ν₄ uses the horizontal lengthscale, so the chain acts along the
    horizontal reference directions."""
    tau_timescale: float
    direction: str = field(default="horizontal", kw_only=True)

    def vars_aux(self) -> VarSpec:
        return VarSpec(delta=1)

    def vars_gradient_laplacian(self) -> VarSpec:
        return VarSpec(u_h=3, h_tot=1)

    def lengthscale(self, grid) -> torch.Tensor:
        """Δ_h ``[E, Np]``: the mean of the two horizontal node spacings,
        from the columns of ∂x/∂ξ = (∂ξ/∂x)⁻¹ (inverted on the host in
        float64), in the grid's dtype and on its device."""
        Jm = np.linalg.inv(grid.xi_x.detach().cpu().double().numpy())
        Nq = grid.Nq
        d1 = np.linalg.norm(Jm[..., :, 0], axis=-1) * 2 / max(Nq[0] - 1, 1)
        d2 = np.linalg.norm(Jm[..., :, 1], axis=-1) * 2 / max(Nq[1] - 1, 1)
        return torch.as_tensor(0.5 * (d1 + d2), dtype=grid.dtype,
                               device=grid.device)

    def init_aux(self, model, grid, aux):
        """Fill ``hyperdiffusion.delta`` with :meth:`lengthscale`."""
        out = aux.clone()
        out[:, model.aux_spec.index("hyperdiffusion.delta")] = \
            self.lengthscale(grid).to(aux.dtype)[:, None]
        return out

    def gradient_laplacian_argument(self, model, q, aux, t, p=None):
        """(u_h, h_tot) ``[E, 4, Np]``: the horizontal velocity and the
        total specific enthalpy (ρe + p)/ρ; ``p`` from the model's thermo
        unless given."""
        rho, ru, rhoe = q[:, 0], q[:, 1:4], q[:, 4]
        if p is None:
            _, p = model.thermo(q, aux)
        u = ru / rho[:, None]
        k = model.aux_spec.get(aux, "orientation.grad_Phi") \
            / model.param_set.grav
        u_h = u - torch.sum(u * k, dim=1, keepdim=True) * k
        return torch.cat([u_h, ((rhoe + p) / rho)[:, None]], dim=1)

    def transform(self, model, grad_lap, q, aux, t):
        """∇Δ ``[E, 3, 4, Np]`` → the hyper state ν₄∇Δ, ν₄ from the aux
        lane ``hyperdiffusion.delta``."""
        delta = model.aux_spec.get(aux, "hyperdiffusion.delta")
        nu4 = (delta / 2) ** 4 / (2 * self.tau_timescale)
        return nu4[:, None, None] * grad_lap

    def flux(self, model, q, hyper, aux, F):
        """Adds ρ ν₄∇Δu_h to F[ρu] and ν₄∇Δu_h·ρu + ρ ν₄∇Δh_tot to F[ρe]
        (F ``[E, 3, n, Np]``, in place) and returns F."""
        rho, ru = q[:, 0], q[:, 1:4]
        F[:, :, 1:4] += rho[:, None, None] * hyper[:, :, :3]
        F[:, :, 4] += (torch.sum(hyper[:, :, :3] * ru[:, None], dim=2)
                       + rho[:, None] * hyper[:, :, 3])
        return F


@dataclass
class EquilMoistBiharmonic(DryBiharmonic):
    """DryBiharmonic with q_tot as a fifth chain variable, diffused on
    the timescale ``tau_timescale_q_tot`` (``tau_timescale`` unless
    given)."""
    tau_timescale_q_tot: float = None

    def __post_init__(self):
        if self.tau_timescale_q_tot is None:
            self.tau_timescale_q_tot = self.tau_timescale

    def vars_gradient_laplacian(self) -> VarSpec:
        return VarSpec(u_h=3, h_tot=1, q_tot=1)

    def gradient_laplacian_argument(self, model, q, aux, t, p=None):
        """(u_h, h_tot, q_tot) ``[E, 5, Np]``."""
        out = super().gradient_laplacian_argument(model, q, aux, t, p)
        sp = model.prog_spec
        q_tot = sp.get(q, "moisture.rhoq_tot") / sp.get(q, "rho")
        return torch.cat([out, q_tot[:, None]], dim=1)

    def transform(self, model, grad_lap, q, aux, t):
        """∇Δ ``[E, 3, 5, Np]`` → (ν₄∇Δu_h, ν₄∇Δh_tot, ν₄_q∇Δq_tot)."""
        delta = model.aux_spec.get(aux, "hyperdiffusion.delta")
        nu4 = (delta / 2) ** 4 / (2 * self.tau_timescale)
        nu4q = (delta / 2) ** 4 / (2 * self.tau_timescale_q_tot)
        return torch.cat([nu4[:, None, None] * grad_lap[:, :, :4],
                          nu4q[:, None, None] * grad_lap[:, :, 4:]], dim=2)

    def flux(self, model, q, hyper, aux, F):
        """DryBiharmonic's flux, and ρ ν₄_q∇Δq_tot added to F[ρq_tot]."""
        F = super().flux(model, q, hyper, aux, F)
        F[:, :, model.prog_spec.index("moisture.rhoq_tot").start] += \
            q[:, 0, None] * hyper[:, :, 4]
        return F
