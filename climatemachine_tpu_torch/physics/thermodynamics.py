"""Dry thermodynamics (port of the dry subset of
``climatemachine_tpu/physics/thermodynamics.py``): the same formulas, in
the same evaluation order, on tensors."""

from __future__ import annotations

import torch

from climatemachine_tpu_torch.physics.parameters import PlanetParameterSet


def internal_energy(ps: PlanetParameterSet, T):
    """Specific internal energy of dry air, e_int(T)."""
    return ps.cv_d * (T - ps.T_0)


def air_temperature(ps: PlanetParameterSet, e_int):
    """T(e_int), the inverse of :func:`internal_energy`."""
    return ps.T_0 + e_int / ps.cv_d


def air_pressure(ps: PlanetParameterSet, T, rho):
    return rho * ps.R_d * T


def soundspeed_air(ps: PlanetParameterSet, T):
    gamma = ps.cp_d / ps.cv_d
    return torch.sqrt(gamma * ps.R_d * T)
