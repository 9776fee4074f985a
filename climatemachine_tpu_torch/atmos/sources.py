"""Gravity and Coriolis sources (port of
``climatemachine_tpu/atmos/sources.py``, ``contributions_vm`` :38,:59).

``contributions_vm(model, ctx, t)`` maps prognostic names to additive
var-major tendencies (``[E, Np]`` scalars, ``[E, 3, Np]`` vectors).
"""

from __future__ import annotations

import torch


class Gravity:
    """−(ρ − ρ_ref) ∇Φ."""

    def contributions_vm(self, model, ctx, t):
        rho = ctx.rho - ctx.aux("ref_state.rho")
        return {"rhou": -rho[:, None, :] * ctx.grad_Phi}


class Coriolis:
    """−2Ω ẑ × ρu with Ω along the x3 axis (spherical orientation)."""

    def contributions_vm(self, model, ctx, t):
        Om = model.param_set.Omega
        ru = ctx.rhou
        return {"rhou": torch.stack([2 * Om * ru[:, 1], -2 * Om * ru[:, 0],
                                     torch.zeros_like(ru[:, 0])], dim=1)}
