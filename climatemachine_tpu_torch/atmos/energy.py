"""The energy variable (port of ``climatemachine_tpu/atmos/energy.py``):
total energy (``TotalEnergyModel``, the default) or the liquid-ice
potential temperature (``ThetaModel``).

The prognostic lane keeps the name ``rhoe``; under :class:`ThetaModel`
it holds ρθ (dry only).  Dry thermodynamics then close in closed form:
Π = (R_d ρθ / p₀)^(R_d/cv_d), T = θ Π, p = ρ R_d T.
"""

from __future__ import annotations


class TotalEnergyModel:
    """Prognostic ρe (the default)."""
    is_theta = False


class ThetaModel:
    """Prognostic ρθ in the ``rhoe`` lane: advected with no pressure
    work, diffused as θ with no viscous heating; dry only."""
    is_theta = True

    @staticmethod
    def thermo_dry(ps, rho, rhotheta):
        """(T, p) from (ρ, ρθ)."""
        theta = rhotheta / rho
        pi_exner = (ps.R_d * rhotheta / ps.MSLP) ** (ps.R_d / ps.cv_d)
        T = theta * pi_exner
        return T, rho * ps.R_d * T
