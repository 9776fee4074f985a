"""The atmosphere's sources (port of
``climatemachine_tpu/atmos/sources.py``: Gravity :26 (with and without
the reference density, :33/:41), Coriolis :46, their
``contributions`` :30,:50 and ``contributions_vm`` :38,:59, and the LES
forcings GeostrophicForcing :67, Subsidence :88 and RayleighSponge
:115 with its ``contributions_vm`` :135), and the base of the
microphysics, canopy and large-scale sources (atmos/precipitation.py,
atmos/canopy.py, atmos/lsforcing.py).

A source maps prognostic names to additive var-major tendencies
(``[E, Np]`` scalars, ``[E, 3, Np]`` vectors) in
``contributions_vm(model, ctx, t)``, from a :class:`VMContext` whose
thermo the caller computed once: the var-major RHS its own, the generic
DG operator the model's (with the state and its phase partition, which
the microphysics sources read) and, with a turbulence closure, its
gradient flux ``gf`` (which Subsidence and the large-scale sources
read; without one they add nothing, as in the JAX package).
``contributions(model, q, gf, aux, t)`` is the JAX package's signature
on state and aux.  A source with ``on_var_major_rhs`` False runs on the
generic DG operator only, as the JAX package's var-major RHS takes only
sources with a ``contributions_vm``.  Vectors are var-major: the cross
product runs over dim 1 (``torch.linalg.cross(..., dim=1)``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

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
    gf: Optional[torch.Tensor] = None


class Source:
    """Base of the atmosphere sources."""

    #: whether the var-major RHS (dg/fast_rhs.py) takes this source
    on_var_major_rhs = True

    def contributions_vm(self, model, ctx: VMContext, t):
        raise NotImplementedError

    def contributions(self, model, q, gf, aux, t):
        """The contributions at state q, gradient flux ``gf`` (or None)
        and aux, T and p from the model's thermo."""
        return self.contributions_vm(
            model, model.source_context(q, aux, gf=gf), t)


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


def _z(model, ctx):
    """The altitude Φ/g ``[E, Np]``."""
    return ctx.aux("orientation.Phi") / model.param_set.grav


def sponge_beta(z, z_sponge, z_max, alpha_max, gamma):
    """β = α_max sin^γ(π/2 · r), r = (z − z_sponge)/(z_max − z_sponge)
    clipped to [0, 1]: the relaxation rate of the LES sponges."""
    r = torch.clamp((z - z_sponge) / (z_max - z_sponge), 0.0, 1.0)
    return alpha_max * torch.sin(math.pi / 2 * r) ** gamma


@dataclass(frozen=True)
class GeostrophicForcing(Source):
    """−f k̂ × (ρu − ρ u_geo), k̂ = ∇Φ/g."""
    f_coriolis: float
    u_geostrophic: float
    v_geostrophic: float
    on_var_major_rhs = False

    def contributions_vm(self, model, ctx, t):
        rho = ctx.rho
        k = ctx.grad_Phi / model.param_set.grav
        u_geo = torch.stack([torch.full_like(rho, self.u_geostrophic),
                             torch.full_like(rho, self.v_geostrophic),
                             torch.zeros_like(rho)], dim=1)
        m = ctx.rhou - rho[:, None] * u_geo
        return {"rhou": -torch.linalg.cross(self.f_coriolis * k, m, dim=1)}


@dataclass(frozen=True)
class Subsidence(Source):
    """Large-scale subsidence w_sub = −D z advecting energy and moisture:
    −ρ w_sub k̂·∇h_tot on ρe and −ρ w_sub k̂·∇q_tot on ρq_tot, from the
    gradient flux (nothing without one)."""
    D: float    # divergence rate [1/s]
    on_var_major_rhs = False

    def contributions_vm(self, model, ctx, t):
        if ctx.gf is None:
            return {}
        ps, fs = model.param_set, model.gf_spec
        rho = ctx.rho
        k = ctx.grad_Phi / ps.grav
        w_sub = -self.D * _z(model, ctx)
        out = {"rhoe": -rho * w_sub * torch.sum(
            fs.get(ctx.gf, "d_h_tot") * k, dim=1)}
        try:
            d_q = fs.get(ctx.gf, "moisture.d_q_tot")
        except KeyError:
            return out
        out["moisture.rhoq_tot"] = -rho * w_sub * torch.sum(d_q * k, dim=1)
        return out


@dataclass(frozen=True)
class RayleighSponge(Source):
    """Relaxes ρu to ρ u_relax above z_sponge: −β (ρu − ρ u_relax), β
    of :func:`sponge_beta`."""
    z_max: float
    z_sponge: float
    alpha_max: float
    u_relaxation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    gamma: float = 2.0

    def contributions_vm(self, model, ctx, t):
        beta = sponge_beta(_z(model, ctx), self.z_sponge, self.z_max,
                           self.alpha_max, self.gamma)
        rho = ctx.rho
        u_rel = torch.stack([torch.full_like(rho, c)
                             for c in self.u_relaxation], dim=1)
        m = ctx.rhou - rho[:, None, :] * u_rel
        return {"rhou": -beta[:, None, :] * m}
