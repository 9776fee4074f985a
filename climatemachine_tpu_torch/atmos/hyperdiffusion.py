"""Horizontal biharmonic hyperdiffusion (port of
``climatemachine_tpu/atmos/hyperdiffusion.py`` ``DryBiharmonic`` :22-86).

ν₄ = (Δ_h/2)⁴ / 2τ with Δ_h the horizontal grid lengthscale, an aux lane
filled once at set-up.  The var-major RHS (dg/fast_rhs.py) runs the LDG
chain ∇→Δ→∇ on (u_h, h_tot) and builds the hyperdiffusive flux
F₂[ρu] = ρν₄∇Δu_h, F₂[ρe] = ν₄∇Δu_h·ρu + ρν₄∇Δh_tot inside the volume
kernel and on the faces.
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
