"""Spherical orientation and coordinate helpers (port of
``climatemachine_tpu/common/orientations.py``).

Var-major: coordinates and vectors are ``[E, 3, Np]`` with the vector
axis at position 1; scalars are ``[E, Np]``.
"""

from __future__ import annotations

import torch

from climatemachine_tpu_torch.physics.parameters import PlanetParameterSet
from climatemachine_tpu_torch.utils.variables import VarSpec


class SphericalOrientation:
    """Φ = g (|x| − planet_radius) and its gradient."""

    def vars_aux(self) -> VarSpec:
        return VarSpec(Phi=1, grad_Phi=3)

    def geopotential(self, ps: PlanetParameterSet, coords):
        r = torch.linalg.vector_norm(coords, dim=1)
        return ps.grav * (r - ps.planet_radius)

    def grad_geopotential(self, ps: PlanetParameterSet, coords):
        r = torch.linalg.vector_norm(coords, dim=1, keepdim=True)
        return ps.grav * coords / r


def latitude(coords):
    """Geocentric latitude; the ratio is clipped because pole nodes can
    give |z|/r = 1 + O(eps)."""
    r = torch.linalg.vector_norm(coords, dim=1)
    return torch.arcsin(torch.clamp(coords[:, 2] / r, -1.0, 1.0))


def longitude(coords):
    return torch.atan2(coords[:, 1], coords[:, 0])


def sphr_to_cart_vec(coords, v_sphere):
    """(zonal, meridional, radial) components → Cartesian vector."""
    lat, lon = latitude(coords), longitude(coords)
    sinl, cosl = torch.sin(lat), torch.cos(lat)
    sinn, cosn = torch.sin(lon), torch.cos(lon)
    lam_hat = torch.stack([-sinn, cosn, torch.zeros_like(sinn)], dim=1)
    phi_hat = torch.stack([-sinl * cosn, -sinl * sinn, cosl], dim=1)
    r_hat = torch.stack([cosl * cosn, cosl * sinn, sinl], dim=1)
    return (v_sphere[:, 0:1] * lam_hat + v_sphere[:, 1:2] * phi_hat
            + v_sphere[:, 2:3] * r_hat)
