"""Monin-Obukhov surface fluxes (port of
``climatemachine_tpu/common/surface_fluxes.py``: the universal
functions ``Businger`` :26, ``Gryanik`` :47 and ``Grachev`` :71,
``surface_conditions`` :108 and ``monin_obukhov_length`` :151).

``surface_conditions`` solves for the Obukhov length by the JAX
package's fixed-point update of (u*, θ*, L) from the neutral start, a
fixed 10 iterations (the count is part of the result), elementwise
over tensors of surface points.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

VON_KARMAN = 0.4


@dataclass(frozen=True)
class Businger:
    """Businger-Dyer stability functions."""
    a_m: float = 4.7
    a_h: float = 4.7
    Pr_0: float = 0.74

    def psi_m(self, zeta):
        x = (1.0 - 15.0 * torch.clamp_max(zeta, 0.0)) ** 0.25
        unst = (2 * torch.log((1 + x) / 2) + torch.log((1 + x * x) / 2)
                - 2 * torch.arctan(x) + math.pi / 2)
        stab = -self.a_m * zeta
        return torch.where(zeta < 0, unst, stab)

    def psi_h(self, zeta):
        y = torch.sqrt(1.0 - 9.0 * torch.clamp_max(zeta, 0.0))
        unst = 2 * torch.log((1 + y) / 2)
        stab = -self.a_h * zeta / self.Pr_0
        return torch.where(zeta < 0, unst, stab)


@dataclass(frozen=True)
class Gryanik(Businger):
    """The stable-regime refit of Gryanik et al. (2020); Businger's
    functions when unstable."""
    a_m: float = 5.0
    b_m: float = 0.3
    a_h: float = 5.0
    b_h: float = 0.4
    Pr_0: float = 0.98

    def psi_m(self, zeta):
        unst = Businger().psi_m(torch.clamp_max(zeta, 0.0))
        zp = torch.clamp_min(zeta, 0.0)
        stab = -3 * self.a_m / self.b_m * \
            ((1 + self.b_m * zp) ** (1.0 / 3.0) - 1)
        return torch.where(zeta < 0, unst, stab)

    def psi_h(self, zeta):
        unst = Businger().psi_h(torch.clamp_max(zeta, 0.0))
        zp = torch.clamp_min(zeta, 0.0)
        stab = -self.Pr_0 * self.a_h / self.b_h * torch.log1p(self.b_h * zp)
        return torch.where(zeta < 0, unst, stab)


@dataclass(frozen=True)
class Grachev(Businger):
    """The SHEBA stable functions of Grachev et al. (2007); Businger's
    when unstable."""
    a_m: float = 5.0
    b_m: float = 0.3

    def psi_m(self, zeta):
        unst = Businger().psi_m(torch.clamp_max(zeta, 0.0))
        zp = torch.clamp_min(zeta, 0.0)
        x = (1 + zp) ** (1.0 / 3.0)
        B = (1.0 / self.b_m) ** (1.0 / 3.0)
        s3 = math.sqrt(3.0)
        stab = (-3 * self.a_m / self.b_m * (x - 1)
                + self.a_m * B / (2 * self.b_m)
                * (2 * torch.log((x + B) / (1 + B))
                   - torch.log((x * x - x * B + B * B)
                               / (1 - B + B * B))
                   + 2 * s3
                   * (torch.arctan((2 * x - B) / (s3 * B))
                      - math.atan((2 - B) / (s3 * B)))))
        return torch.where(zeta < 0, unst, stab)

    def psi_h(self, zeta):
        unst = Businger().psi_h(torch.clamp_max(zeta, 0.0))
        zp = torch.clamp_min(zeta, 0.0)
        stab = -2.5 * torch.log1p(3 * zp + zp * zp)  # a_h=5, b_h=5, c_h=3
        return torch.where(zeta < 0, unst, stab)


class SurfaceFluxConditions(NamedTuple):
    L_MO: torch.Tensor
    u_star: torch.Tensor
    theta_star: torch.Tensor
    shf: torch.Tensor          # kinematic heat flux w'θ' = −u*θ*
    C_drag: torch.Tensor
    C_heat: torch.Tensor


def _nonzero(x, eps):
    """x where |x| ≥ eps, else ``eps`` (the JAX package's guard)."""
    return torch.where(torch.abs(x) < eps, eps, x)


def surface_conditions(param_set, u_in, theta_in, theta_sfc, z_in,
                       z0_m, z0_h=None, uf=Businger(), n_iter: int = 10
                       ) -> SurfaceFluxConditions:
    """Monin-Obukhov similarity: u*, θ*, L and the exchange coefficients
    from the wind speed ``u_in`` and potential temperature ``theta_in``
    at height ``z_in`` and the surface's ``theta_sfc``, roughness
    lengths ``z0_m`` (and ``z0_h``, default z0_m); tensors that
    broadcast together (z_in and the roughness lengths may be
    floats)."""
    k = VON_KARMAN
    g = param_set.grav
    z0_h = z0_m if z0_h is None else z0_h
    u = torch.clamp_min(u_in, 0.01)
    dtheta = theta_in - theta_sfc
    as_t = lambda x: torch.as_tensor(x, dtype=u.dtype, device=u.device)
    z_in, z0_m, z0_h = as_t(z_in), as_t(z0_m), as_t(z0_h)

    log_m = torch.log(z_in / z0_m)
    log_h = torch.log(z_in / z0_h)
    u_star = k * u / log_m
    th_star = k * dtheta / log_h

    for _ in range(n_iter):
        L = (u_star ** 2 * theta_in
             / (k * g * torch.where(torch.abs(th_star) < 1e-10,
                                    torch.sign(th_star) * 1e-10 + 1e-10,
                                    th_star)))
        zeta = torch.clamp(z_in / L, -10.0, 10.0)
        zeta0m = torch.clamp(z0_m / L, -10.0, 10.0)
        zeta0h = torch.clamp(z0_h / L, -10.0, 10.0)
        denom_m = log_m - uf.psi_m(zeta) + uf.psi_m(zeta0m)
        denom_h = log_h - uf.psi_h(zeta) + uf.psi_h(zeta0h)
        u_star = k * u / torch.clamp_min(denom_m, 1e-3)
        th_star = k * dtheta / torch.clamp_min(denom_h, 1e-3)

    L = u_star ** 2 * theta_in / (k * g * _nonzero(th_star, 1e-10))
    C_d = (u_star / u) ** 2
    C_h = u_star * th_star / _nonzero(u * dtheta, 1e-14)
    return SurfaceFluxConditions(L_MO=L, u_star=u_star, theta_star=th_star,
                                 shf=-u_star * th_star, C_drag=C_d,
                                 C_heat=C_h)


def monin_obukhov_length(param_set, u_star, theta, flux_wtheta):
    """L = −u*³ θ / (κ g w'θ')."""
    return -u_star ** 3 * theta / (VON_KARMAN * param_set.grav
                                   * _nonzero(flux_wtheta, 1e-14))
