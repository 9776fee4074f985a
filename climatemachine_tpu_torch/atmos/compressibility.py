"""Compressibility (port of
``climatemachine_tpu/atmos/compressibility.py``): fully compressible
(``Compressible``, the default) or the 1-D anelastic constraint
(``Anelastic1D``).

Under ``Anelastic1D`` the state's density is the reference density for
all time (no mass flux or mass source; the initial state takes ρ =
ρ_ref), the thermodynamic pressure is the reference pressure, the
vertical momentum fluxes and sources are removed, and the wave speed has
no sound speed.
"""

from __future__ import annotations


class Compressible:
    """Fully compressible (the default)."""
    is_anelastic = False


class Anelastic1D:
    """Constant reference density, reference-pressure thermodynamics, no
    vertical momentum tendencies, no acoustics."""
    is_anelastic = True
