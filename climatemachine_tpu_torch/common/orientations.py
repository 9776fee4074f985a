"""Orientations and coordinate helpers (port of
``climatemachine_tpu/common/orientations.py``: the ``Orientation`` base
:21-52 with ``altitude`` and ``vertical_unit_vector``, ``NoOrientation``
:55-67, ``FlatOrientation`` :70-78 and ``SphericalOrientation``
:81-90).

An orientation fills the geopotential Φ and its gradient ∇Φ into aux.
Var-major: coordinates and vectors are ``[E, 3, Np]`` with the vector
axis at position 1; scalars are ``[E, Np]``.
"""

from __future__ import annotations

import torch

from climatemachine_tpu_torch.physics.parameters import PlanetParameterSet
from climatemachine_tpu_torch.utils.variables import VarSpec


class Orientation:
    """Base: the aux lanes Φ (scalar) and ∇Φ (3-vector)."""

    def vars_aux(self) -> VarSpec:
        return VarSpec(Phi=1, grad_Phi=3)

    def geopotential(self, ps: PlanetParameterSet, coords):
        raise NotImplementedError

    def grad_geopotential(self, ps: PlanetParameterSet, coords):
        raise NotImplementedError

    @staticmethod
    def altitude(ps: PlanetParameterSet, Phi):
        """z = Φ/g."""
        return Phi / ps.grav

    @staticmethod
    def vertical_unit_vector(ps: PlanetParameterSet, grad_Phi):
        """k̂ = ∇Φ/g ``[E, 3, L]``."""
        return grad_Phi / ps.grav


class NoOrientation(Orientation):
    """Φ = 0: no gravity geometry (gravity-free test configurations such
    as the isentropic vortex); it has no altitude."""

    def geopotential(self, ps, coords):
        return torch.zeros_like(coords[:, -1])

    def grad_geopotential(self, ps, coords):
        return torch.zeros_like(coords)

    @staticmethod
    def altitude(ps, Phi):
        raise ValueError("NoOrientation has no altitude")


class FlatOrientation(Orientation):
    """Φ = g z with z the last coordinate."""

    def geopotential(self, ps, coords):
        return ps.grav * coords[:, -1]

    def grad_geopotential(self, ps, coords):
        g = torch.zeros_like(coords)
        g[:, -1] = ps.grav
        return g


class SphericalOrientation(Orientation):
    """Φ = g (|x| − planet_radius) and its gradient."""

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
