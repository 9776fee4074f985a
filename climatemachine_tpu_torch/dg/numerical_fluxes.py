"""Interface (numerical) fluxes on var-major face lanes (port of
``climatemachine_tpu/dg/numerical_fluxes.py`` ``RusanovNumericalFlux``
:34-50).

Face data is var-major: states ``[E, n, X]`` over X face nodes, unit
normals ``[E, 3, X]``; a balance law's ``flux_first_order`` gives
``[E, 3, n, X]`` (direction i, then variable) and its ``wavespeed``
``[E, X]``.  The result is the normal numerical flux ``[E, n, X]``.
"""

from __future__ import annotations


class RusanovNumericalFlux:
    """Local Lax-Friedrichs: the central flux ½(F⁻ + F⁺)·n minus
    ½·max(c⁻, c⁺)·(q⁺ − q⁻)."""

    def __call__(self, bl, nrm, qM, auxM, qP, auxP, t):
        Fs = bl.flux_first_order(qM, auxM, t) + bl.flux_first_order(qP, auxP,
                                                                     t)
        central = 0.5 * (Fs[:, 0] * nrm[:, 0, None] + Fs[:, 1] * nrm[:, 1, None]
                         + Fs[:, 2] * nrm[:, 2, None])
        c = bl.wavespeed(nrm, qM, auxM, t).maximum(
            bl.wavespeed(nrm, qP, auxP, t))
        return central - 0.5 * c[:, None] * (qP - qM)
