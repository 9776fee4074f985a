"""The prognostic subgrid-scale TKE model of Deardorff (1980) (port of
``climatemachine_tpu/atmos/sgstke.py`` ``SGStkeModel`` :23-134).

It adds the prognostic lane ρe_SGS, advected with the flow (the model's
first-order flux advects every lane past ρe), diffused with −2ρν∇e_SGS,
produced by the resolved shear −ρ τ:S and the buoyancy flux (g/T_ref)(A
F_θli + 0.61 F_qt)·k̂, and dissipated at ρ C e^{3/2}/l, C = 0.19 + 0.51
l/Δ, with the stability length l = min(0.76 √e / N_θ, Δ).  Its gradient
lanes are e_SGS and θ_li, its gradient-flux lanes ∇e_SGS and ∇θ_li.  The
:class:`~climatemachine_tpu_torch.common.turbulence.Deardorff` closure
draws its viscosity ν = 0.1 l √e from this state.  Var-major: scalars
``[E, L]``, vectors ``[E, 3, L]``, ν and D_t ``[E, 3, L]``.
"""

from __future__ import annotations

import torch

from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.utils.variables import VarSpec


class SGStkeModel:
    """The ρe_SGS component of ``AtmosPhysics.sgstke`` (module
    docstring)."""

    def vars_prognostic(self) -> VarSpec:
        return VarSpec(rhoe_SGS=1)

    def vars_gradient(self) -> VarSpec:
        return VarSpec(e_SGS=1, theta_li=1)

    def vars_gradient_flux(self) -> VarSpec:
        return VarSpec(d_e_SGS=3, d_theta_li=3)

    @staticmethod
    def tke(model, q):
        """e_SGS = max(ρe_SGS/ρ, 0)."""
        sp = model.prog_spec
        return torch.clamp_min(sp.get(q, "sgstke.rhoe_SGS")
                               / sp.get(q, "rho"), 0.0)

    @staticmethod
    def _theta_li(model, q, aux):
        T, p, _, pp = model.thermo_full(q, aux)
        return td.liquid_ice_pottemp(model.param_set, T, p, pp)

    @staticmethod
    def _T_ref(model, aux):
        """The reference state's T, else 288 K."""
        try:
            return model.aux_spec.get(aux, "ref_state.T")
        except KeyError:
            return 288.0

    def stability_length(self, model, q, gf, aux):
        """(l = min(0.76 √e / N_θ, Δ), Δ, e), N_θ² = |g/T_ref ∂θ_li/∂z|."""
        ps = model.param_set
        e = self.tke(model, q)
        delta = model.aux_spec.get(aux, "turbulence.delta")
        dth = model.gf_spec.get(gf, "sgstke.d_theta_li")
        N2 = torch.abs((ps.grav / self._T_ref(model, aux)) * dth[:, 2])
        l_s = 0.76 * torch.sqrt(e) / torch.sqrt(N2 + 1e-20)
        return torch.minimum(l_s, delta), delta, e

    def gradient_argument(self, model, q, aux, t, out):
        """e_SGS and θ_li into their lanes of ``out``."""
        gs = model.grad_spec
        out = out.clone()
        out[:, gs.index("sgstke.e_SGS").start] = self.tke(model, q)
        out[:, gs.index("sgstke.theta_li").start] = self._theta_li(model, q,
                                                                   aux)
        return out

    def gradient_flux(self, model, grad_g, q, aux, t, out):
        """∇e_SGS and ∇θ_li into their lanes of ``out``."""
        gs, fs = model.grad_spec, model.gf_spec
        out = out.clone()
        for flux, arg in (("d_e_SGS", "e_SGS"), ("d_theta_li", "theta_li")):
            out[:, fs.index(f"sgstke.{flux}")] = grad_g[
                :, :, gs.index(f"sgstke.{arg}").start]
        return out

    def flux_second_order(self, model, q, gf, aux, nu, F):
        """Adds −2ρν∇e_SGS to F[ρe_SGS] (in place); returns F."""
        sp = model.prog_spec
        d_e = model.gf_spec.get(gf, "sgstke.d_e_SGS")
        F[:, :, sp.index("sgstke.rhoe_SGS").start] += (
            -2.0 * sp.get(q, "rho")[:, None] * nu * d_e)
        return F

    def source(self, model, q, gf, aux, t):
        """dρe_SGS/dt ``[E, L]``: shear and buoyancy production and
        dissipation (0 without a gradient flux)."""
        from climatemachine_tpu_torch.common.turbulence import _unpack_sym
        ps, sp, fs = model.param_set, model.prog_spec, model.gf_spec
        rho = sp.get(q, "rho")
        if gf is None:
            return torch.zeros_like(rho)
        nu, D_t = model.physics.turbulence.viscosity(model, q, gf, aux, t)
        S = _unpack_sym(fs.get(gf, "S"))
        tau = -2.0 * nu[:, :, None] * S
        shear = -rho * torch.sum(tau * S, dim=(1, 2))

        T_ref = self._T_ref(model, aux)
        f_th = -rho[:, None] * D_t * fs.get(gf, "sgstke.d_theta_li")
        try:
            q_tot = sp.get(q, "moisture.rhoq_tot") / rho
            f_qt = -rho[:, None] * D_t * fs.get(gf, "moisture.d_q_tot")
            A = 1.0 + 0.61 * q_tot
            buoy = (ps.grav / T_ref) * (A * f_th[:, 2] + 0.61 * f_qt[:, 2])
        except KeyError:
            buoy = (ps.grav / T_ref) * f_th[:, 2]

        l, delta, e = self.stability_length(model, q, gf, aux)
        C = 0.19 + 0.51 * (l / delta)
        diss = -rho * C * e ** 1.5 / torch.clamp_min(l, 1e-10)
        return shear + buoy + diss
