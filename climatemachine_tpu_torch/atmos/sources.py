"""Gravity and Coriolis sources (port of
``climatemachine_tpu/atmos/sources.py``: Gravity :26 (with and without
the reference density, :33/:41), Coriolis :46, their
``contributions`` :30,:50 and ``contributions_vm`` :38,:59), and the
base of the microphysics sources (atmos/precipitation.py).

A source maps prognostic names to additive var-major tendencies
(``[E, Np]`` scalars, ``[E, 3, Np]`` vectors) in
``contributions_vm(model, ctx, t)``, from a :class:`VMContext` whose
thermo the caller computed once: the var-major RHS its own, the generic
DG operator the model's (with the state and its phase partition, which
the microphysics sources read).  ``contributions(model, q, gf, aux, t)``
is the JAX package's signature on state and aux.  A source with
``on_var_major_rhs`` False runs on the generic DG operator only, as the
JAX package's var-major RHS takes only sources with a
``contributions_vm``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass
class VMContext:
    """What the var-major source hooks see: ``[E, Np]`` scalars,
    ``[E, 3, Np]`` vectors; ``aux(name)`` reads var-major aux lanes.  On
    the generic DG operator ``q`` is the state ``[E, n, Np]`` and ``pp``
    the moisture model's phase partition (None when dry); the var-major
    RHS passes neither."""
    rho: torch.Tensor
    rhou: torch.Tensor
    T: torch.Tensor
    p: torch.Tensor
    grad_Phi: torch.Tensor
    coords: torch.Tensor
    aux: Callable
    q: Optional[torch.Tensor] = None
    pp: Optional[object] = None


class Source:
    """Base of the atmosphere sources."""

    #: whether the var-major RHS (dg/fast_rhs.py) takes this source
    on_var_major_rhs = True

    def contributions_vm(self, model, ctx: VMContext, t):
        raise NotImplementedError

    def contributions(self, model, q, gf, aux, t):
        """The contributions at state q and aux, T and p from the model's
        thermo; ``gf`` (gradient flux) is unused by these sources."""
        return self.contributions_vm(model, model.source_context(q, aux), t)


class Gravity(Source):
    """−(ρ − ρ_ref) ∇Φ, or −ρ∇Φ where the reference state does not
    subtract."""

    def contributions_vm(self, model, ctx, t):
        rho = ctx.rho
        if model.ref_state.subtract_off:
            rho = rho - ctx.aux("ref_state.rho")
        return {"rhou": -rho[:, None, :] * ctx.grad_Phi}


class Coriolis(Source):
    """−2Ω ẑ × ρu with Ω along the x3 axis (spherical orientation)."""

    def contributions_vm(self, model, ctx, t):
        Om = model.param_set.Omega
        ru = ctx.rhou
        return {"rhou": torch.stack([2 * Om * ru[:, 1], -2 * Om * ru[:, 0],
                                     torch.zeros_like(ru[:, 0])], dim=1)}
