"""Subgrid-scale turbulence closures (port of
``climatemachine_tpu/common/turbulence.py``: the ``TurbulenceClosure``
base :48-160, ``UpperAtmosSponge`` :162, ``ConstantKinematicViscosity``
:182, ``ConstantDynamicViscosity`` :193, ``SmagorinskyLilly`` :204,
``Vreman`` :231, ``AnisoMinDiss`` :296, ``Deardorff`` :353 with the SGS
TKE model of atmos/sgstke.py).

A closure owns the model's second-order chain: the gradient arguments
(u, h_tot and, buoyancy-aware, θ_v), the gradient flux it keeps of their
gradients (the strain rate S or ∇u, ∇h_tot, N²) and the viscous fluxes
F[ρu] = ρτ, F[ρe] = τ·ρu − ρ D_t ∇h_tot with τ = −2 diag(ν) S.

Var-major: state and aux ``[E, n, L]`` over L nodes (volume or face
lanes), gradient arguments ``[E, ng, L]``, their gradient ``[E, 3, ng,
L]`` (direction i, then variable), the gradient flux ``[E, ngf, L]``
(S packed as 11, 22, 33, 12, 13, 23; ∇u as 9 lanes c·3 + j of ∂u_j/∂x_c;
vectors in i order), ν and D_t ``[E, 3, L]``, the flux ``[E, 3, n, L]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from climatemachine_tpu_torch.utils.variables import VarSpec


def _sym(grad_u):
    """S = ½(∇u + ∇uᵀ) of ∇u ``[E, 3, 3, L]``."""
    return 0.5 * (grad_u + grad_u.transpose(1, 2))


def strain_rate_magnitude(S):
    """|S| = sqrt(2 S_ij S_ij) ``[E, L]`` of S ``[E, 3, 3, L]``."""
    return torch.sqrt(2.0 * torch.sum(S * S, dim=(1, 2)))


def _pack_sym(S):
    """Symmetric ``[E, 3, 3, L]`` → 6 lanes (11, 22, 33, 12, 13, 23)."""
    return torch.stack([S[:, 0, 0], S[:, 1, 1], S[:, 2, 2], S[:, 0, 1],
                        S[:, 0, 2], S[:, 1, 2]], dim=1)


def _unpack_sym(s6):
    r0 = torch.stack([s6[:, 0], s6[:, 3], s6[:, 4]], dim=1)
    r1 = torch.stack([s6[:, 3], s6[:, 1], s6[:, 5]], dim=1)
    r2 = torch.stack([s6[:, 4], s6[:, 5], s6[:, 2]], dim=1)
    return torch.stack([r0, r1, r2], dim=1)


def _grad_u(model, grad_g):
    """∇u ``[E, 3, 3, L]`` (∂u_j/∂x_c at [c, j]) of the gradient."""
    return grad_g[:, :, model.grad_spec.index("u")]


def _buoyancy_n2(closure, model, grad_g, q, aux):
    """N² = ∇θ_v·∇Φ / θ_v ``[E, L]``."""
    grad_tv = grad_g[:, :, model.grad_spec.index("theta_v").start]
    grad_Phi = model.aux_spec.get(aux, "orientation.grad_Phi")
    return torch.sum(grad_tv * grad_Phi, dim=1) / closure._theta_v(model, q,
                                                                   aux)


def _buoyancy_factor(model, nu0, N2, normS, aux):
    """diag(ν) with ν's vertical part scaled by f_b² = sqrt(clip(1 −
    Ri/Pr_t, 0, 1)), Ri = N²/|S|²."""
    ps = model.param_set
    Ri = N2 / (normS ** 2 + 1e-30)
    f_b2 = torch.sqrt(torch.clamp(1.0 - Ri * ps.inv_Pr_turb, 0.0, 1.0))
    k = model.aux_spec.get(aux, "orientation.grad_Phi") / ps.grav
    nu_v = k * torch.sum(nu0[:, None] * k, dim=1, keepdim=True)
    return nu0[:, None] - nu_v + nu_v * f_b2[:, None]


class TurbulenceClosure:
    """Base closure: gradient arguments u, h_tot (and θ_v where
    ``needs_theta_v``), the aux lane ``turbulence.delta`` where
    ``needs_delta``."""

    needs_theta_v = False
    needs_delta = False
    #: the ∇u closures' gradient flux also keeps S
    keeps_strain = False
    #: the flux applies the physics' viscous sponge
    takes_sponge = True
    #: the viscosity reads the gradient flux (so a Courant estimate,
    #: which has none, takes its diffusive Courant number as 0)
    viscosity_needs_gradient_flux = False

    def vars_aux(self) -> VarSpec:
        return VarSpec(delta=1) if self.needs_delta else VarSpec()

    def vars_gradient(self) -> VarSpec:
        f = dict(u=3, h_tot=1)
        if self.needs_theta_v:
            f["theta_v"] = 1
        return VarSpec(**f)

    def vars_gradient_flux(self) -> VarSpec:
        f = dict(S=6, d_h_tot=3)
        if self.needs_theta_v:
            f["N2"] = 1
        return VarSpec(**f)

    def init_aux(self, model, grid, aux):
        """Fill ``turbulence.delta`` with the grid lengthscale 2 J^(1/3) /
        N (N the largest polynomial order)."""
        if not self.needs_delta:
            return aux
        maxpoly = max(nq - 1 for nq in grid.Nq)
        out = aux.clone()
        out[:, model.aux_spec.index("turbulence.delta")] = (
            2.0 * grid.J ** (1.0 / 3.0) / max(maxpoly, 1)).to(
                aux.dtype)[:, None]
        return out

    def gradient_argument(self, model, q, aux, t):
        """(u, h_tot = (ρe + p)/ρ[, θ_v]) on the model's gradient lanes
        ``[E, ng, L]`` (the moisture and tracer lanes left 0); under
        ``ThetaModel`` the h_tot lane holds θ = ρθ/ρ."""
        sp, gs = model.prog_spec, model.grad_spec
        rho, rhoe = sp.get(q, "rho"), sp.get(q, "rhoe")
        _, p, u, _ = model.thermo_full(q, aux)
        out = q.new_zeros((q.shape[0], gs.num, q.shape[2]))
        out[:, gs.index("u")] = u
        h_tot = rhoe / rho if model.physics.energy.is_theta \
            else (rhoe + p) / rho
        out[:, gs.index("h_tot")] = h_tot[:, None]
        if self.needs_theta_v:
            out[:, gs.index("theta_v")] = self._theta_v(model, q, aux)[:, None]
        return out

    @staticmethod
    def _theta_v(model, q, aux):
        """θ_v from the moisture model's aux lane, else from T and p."""
        try:
            return model.aux_spec.get(aux, "moisture.theta_v")
        except KeyError:
            ps = model.param_set
            T, p = model.thermo(q, aux)
            return T * (ps.MSLP / p) ** ps.kappa_d

    def gradient_flux(self, model, grad_g, q, aux, t):
        """S (packed), ∇h_tot[, N²] ``[E, ngf, L]`` of the gradient."""
        fs, gs = model.gf_spec, model.grad_spec
        out = q.new_zeros((q.shape[0], fs.num, q.shape[2]))
        out[:, fs.index("S")] = _pack_sym(_sym(_grad_u(model, grad_g)))
        out[:, fs.index("d_h_tot")] = grad_g[:, :, gs.index("h_tot").start]
        if self.needs_theta_v:
            out[:, fs.index("N2")] = _buoyancy_n2(self, model, grad_g, q,
                                                  aux)[:, None]
        return out

    def viscosity(self, model, q, gf, aux, t):
        """(ν ``[E, 3, L]``, D_t ``[E, 3, L]``); closure-specific."""
        raise NotImplementedError

    def _strain(self, model, gf):
        return _unpack_sym(model.gf_spec.get(gf, "S"))

    def flux(self, model, q, gf, aux, t):
        """F[ρu] = ρτ, F[ρe] = τ·ρu − ρ D_t ∇h_tot ``[E, 3, n, L]``, with
        the sponge's amplification of ν and D_t where the physics has
        one; under ``ThetaModel`` F[ρθ] = −ρ D_t ∇θ (no viscous
        heating)."""
        sp = model.prog_spec
        rho, rhou = sp.get(q, "rho"), sp.get(q, "rhou")
        nu, D_t = self.viscosity(model, q, gf, aux, t)
        sponge = model.physics.viscoussponge
        if sponge is not None and self.takes_sponge:
            nu, D_t = sponge.modify(model, aux, nu, D_t)
        tau = -2.0 * nu[:, :, None] * self._strain(model, gf)
        d_h_tot = model.gf_spec.get(gf, "d_h_tot")
        F = q.new_zeros((q.shape[0], 3, sp.num, q.shape[2]))
        F[:, :, sp.index("rhou")] = rho[:, None, None] * tau
        F[:, :, sp.index("rhoe").start] = -rho[:, None] * D_t * d_h_tot
        if not model.physics.energy.is_theta:
            F[:, :, sp.index("rhoe").start] += torch.sum(
                tau * rhou[:, None], dim=2)
        return F


@dataclass
class UpperAtmosSponge:
    """Viscosity amplified by 1 + β in an upper sponge layer, β =
    α_max sin^γ(π/2 · (z − z_s)/(z_max − z_s)) clipped to the layer."""
    z_max: float
    z_sponge: float
    alpha_max: float = 1.0
    gamma: float = 2.0

    def modify(self, model, aux, nu, D_t):
        ps = model.param_set
        z = model.aux_spec.get(aux, "orientation.Phi") / ps.grav
        r = torch.clamp((z - self.z_sponge) / (self.z_max - self.z_sponge),
                        0.0, 1.0)
        beta = self.alpha_max * torch.sin(math.pi / 2 * r) ** self.gamma
        amp = (1.0 + beta)[:, None]
        return nu * amp, D_t * amp


@dataclass
class ConstantKinematicViscosity(TurbulenceClosure):
    """ν = const."""
    nu: float = 0.0

    def viscosity(self, model, q, gf, aux, t):
        rho = model.prog_spec.get(q, "rho")
        nu = torch.full((rho.shape[0], 3, rho.shape[1]), self.nu,
                        dtype=rho.dtype, device=rho.device)
        return nu, nu * model.param_set.inv_Pr_turb


@dataclass
class ConstantDynamicViscosity(TurbulenceClosure):
    """μ = ρν = const."""
    rho_nu: float = 0.0

    def viscosity(self, model, q, gf, aux, t):
        rho = model.prog_spec.get(q, "rho")
        nu = (self.rho_nu / rho)[:, None].expand(-1, 3, -1)
        return nu, nu * model.param_set.inv_Pr_turb


@dataclass
class SmagorinskyLilly(TurbulenceClosure):
    """ν = |S| (C_s δ)² + 1e-5 with the buoyancy-adjusted vertical part."""
    C_smag: float = 0.21
    needs_theta_v = True
    needs_delta = True
    viscosity_needs_gradient_flux = True

    def viscosity(self, model, q, gf, aux, t):
        fs = model.gf_spec
        normS = strain_rate_magnitude(_unpack_sym(fs.get(gf, "S")))
        delta = model.aux_spec.get(aux, "turbulence.delta")
        nu0 = normS * (self.C_smag * delta) ** 2 + 1e-5
        nu = _buoyancy_factor(model, nu0, fs.get(gf, "N2"), normS, aux)
        return nu, nu * model.param_set.inv_Pr_turb


def _grad_u_flux(self, model, grad_g, q, aux, t):
    """The gradient flux of the closures that keep ∇u (9 lanes)."""
    fs, gs = model.gf_spec, model.grad_spec
    grad_u = _grad_u(model, grad_g)
    out = q.new_zeros((q.shape[0], fs.num, q.shape[2]))
    out[:, fs.index("grad_u")] = grad_u.reshape(grad_u.shape[0], 9,
                                                grad_u.shape[-1])
    if self.keeps_strain:
        out[:, fs.index("S")] = _pack_sym(_sym(grad_u))
    out[:, fs.index("d_h_tot")] = grad_g[:, :, gs.index("h_tot").start]
    out[:, fs.index("N2")] = _buoyancy_n2(self, model, grad_g, q,
                                          aux)[:, None]
    return out


def _alpha(model, gf):
    """α ``[E, 3, 3, L]``, α_cj = ∂u_j/∂x_c, from the gradient flux."""
    a = model.gf_spec.get(gf, "grad_u")
    return a.reshape(a.shape[0], 3, 3, a.shape[-1])


@dataclass
class Vreman(TurbulenceClosure):
    """Vreman (2004): ν = c_v sqrt(B_β / α:α) + 1e-5, c_v = 2.5 C_s²."""
    C_smag: float = 0.21
    needs_theta_v = True
    needs_delta = True
    viscosity_needs_gradient_flux = True
    # the JAX package's Vreman flux (turbulence.py:277-293) leaves the
    # sponge out; the port keeps its semantics
    takes_sponge = False

    def vars_gradient_flux(self) -> VarSpec:
        return VarSpec(grad_u=9, d_h_tot=3, N2=1)

    gradient_flux = _grad_u_flux

    def viscosity(self, model, q, gf, aux, t):
        alpha = _alpha(model, gf)
        delta = model.aux_spec.get(aux, "turbulence.delta")
        aij2 = torch.sum(alpha * alpha, dim=(1, 2))
        beta = delta[:, None, None] ** 2 * torch.einsum(
            "emil,emjl->eijl", alpha, alpha)
        Bb = (beta[:, 0, 0] * beta[:, 1, 1] + beta[:, 1, 1] * beta[:, 2, 2]
              + beta[:, 0, 0] * beta[:, 2, 2] - beta[:, 0, 1] ** 2
              - beta[:, 0, 2] ** 2 - beta[:, 1, 2] ** 2)
        c_v = 2.5 * self.C_smag ** 2
        nu0 = c_v * torch.sqrt(torch.clamp(Bb, min=0.0)
                               / torch.clamp(aij2, min=1e-30)) + 1e-5
        nu = nu0[:, None].expand(-1, 3, -1)
        return nu, nu * model.param_set.inv_Pr_turb

    def _strain(self, model, gf):
        return _sym(_alpha(model, gf))


@dataclass
class AnisoMinDiss(TurbulenceClosure):
    """Anisotropic minimum dissipation: ν = (C_P δ)² max(1e-5,
    −(∇uᵀ∇u):S / (∇u:∇u)), its vertical part scaled by f_b²."""
    C_poincare: float = 1.0 / (math.pi ** 2)
    needs_theta_v = True
    needs_delta = True
    viscosity_needs_gradient_flux = True
    keeps_strain = True

    def vars_gradient_flux(self) -> VarSpec:
        return VarSpec(grad_u=9, S=6, d_h_tot=3, N2=1)

    gradient_flux = _grad_u_flux

    def viscosity(self, model, q, gf, aux, t):
        fs = model.gf_spec
        alpha = _alpha(model, gf)
        S = _unpack_sym(fs.get(gf, "S"))
        normS = strain_rate_magnitude(S)
        delta = model.aux_spec.get(aux, "turbulence.delta")
        num = -torch.einsum("eiml,ejml,eijl->el", alpha, alpha, S)
        den = torch.sum(alpha * alpha, dim=(1, 2)) + 1e-30
        nu0 = (self.C_poincare * delta) ** 2 * torch.clamp(num / den,
                                                           min=1e-5)
        nu = _buoyancy_factor(model, nu0, fs.get(gf, "N2"), normS, aux)
        return nu, nu * model.param_set.inv_Pr_turb


@dataclass
class Deardorff(TurbulenceClosure):
    """Deardorff's TKE closure: ν = 0.1 l √e and D_t = (1 + 2l/Δ) ν,
    isotropic, with e and the stability length l from the paired
    :class:`~climatemachine_tpu_torch.atmos.sgstke.SGStkeModel`
    (``AtmosPhysics.sgstke``)."""
    needs_delta = True
    viscosity_needs_gradient_flux = True

    def viscosity(self, model, q, gf, aux, t):
        sg = model.physics.sgstke
        if sg is None:
            raise ValueError("Deardorff needs AtmosPhysics.sgstke")
        l, delta, e = sg.stability_length(model, q, gf, aux)
        nu0 = 0.1 * l * torch.sqrt(e)
        D_t0 = (1.0 + 2.0 * l / delta) * nu0
        return (nu0[:, None].expand(-1, 3, -1),
                D_t0[:, None].expand(-1, 3, -1))
