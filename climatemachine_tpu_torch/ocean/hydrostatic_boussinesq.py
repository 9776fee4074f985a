"""The 3-D hydrostatic Boussinesq ocean (port of
``climatemachine_tpu/ocean/hydrostatic_boussinesq.py``: ``OceanForcing``,
``HydrostaticBoussinesqModel`` :47-321, ``LinearHBModel`` :324-365).

The primitive hydrostatic equations with a linear free surface:
  ∂u/∂t + ∇·(v⊗u + g(η + pkin) Iʰ) = −f×u + ∇·(ν∇u) + forcing
  ∂η/∂t = w(z = 0)
  ∂θ/∂t + ∇·(vθ) = ∇·(κ∇θ)
with w = −∫_b^z ∇ʰ·u dz (continuity) and pkin = ∫_z^0 −αᵀθ dz.

A :class:`~climatemachine_tpu_torch.balance_laws.interface.BalanceLaw`
on the generic DG operator's gradient path; ``coupling`` is stored, as
in the JAX package: the split-explicit ocean's baroclinic side is the
subclass ``CoupledHBModel`` (ocean/split_explicit.py).  Before each stage,
``preprocess_state`` (``DGModel.pre_stage``) filters u with a vertical
cut-off and θ with a vertical exponential filter; after the gradient
pass, ``update_auxiliary_state_gradient`` fills w, pkin and w(z = 0)
by stack integrals (dg/columns.py).  All of it is plain PyTorch, as the
JAX package leaves it to XLA.  Lanes, var-major ``[E, n, L]``:
prognostic u[0], u[1], η, θ; aux coord(3), y, w, pkin, wz0, ud(2),
dGu(2); gradient u(2), θ; gradient flux ∇ʰ·u, ν∇u (3 × 2, direction
i then component c at 2i + c), κ∇θ (3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from climatemachine_tpu_torch.balance_laws import state_types as st
from climatemachine_tpu_torch.balance_laws.interface import BalanceLaw
from climatemachine_tpu_torch.dg.columns import ColumnOpsCache
from climatemachine_tpu_torch.mesh.filters import (CutoffFilter,
                                                   ExponentialFilter)
from climatemachine_tpu_torch.ocean import core as oc
from climatemachine_tpu_torch.physics.parameters import (EARTH,
                                                         PlanetParameterSet)
from climatemachine_tpu_torch.utils.variables import VarSpec


@dataclass
class OceanForcing:
    """Pointwise forcing of u, v, η, θ: each ``f(y, t, u, v, w, η, θ)``
    or None."""
    u: Optional[Callable] = None
    v: Optional[Callable] = None
    eta: Optional[Callable] = None
    theta: Optional[Callable] = None


class HydrostaticBoussinesqModel(BalanceLaw):
    """The ocean balance law; ``momentum_advection`` None (the
    reference's default) or "nonlinear" for ∇·(v⊗u),
    ``tracer_advection`` "nonlinear" for ∇·(vθ)."""

    def __init__(self, problem, param_set: PlanetParameterSet = EARTH,
                 coupling=None, momentum_advection=None,
                 tracer_advection="nonlinear",
                 forcing: OceanForcing = None,
                 rho_o=1000.0, c_h=0.0, c_z=0.0, alpha_T=2e-4,
                 nu_h=5e3, nu_z=5e-3, kappa_h=1e3, kappa_z=1e-4,
                 kappa_c=1e-1, f_o=1e-4, beta=1e-11,
                 apply_vert_filters: bool = True):
        self.coupling = coupling or oc.Uncoupled()
        self.apply_vert_filters = apply_vert_filters
        self.problem = problem
        self.param_set = param_set
        self.momentum_advection = momentum_advection
        self.tracer_advection = tracer_advection
        self.forcing = forcing or OceanForcing()
        self.rho_o, self.c_h, self.c_z = rho_o, c_h, c_z
        self.alpha_T = alpha_T
        self.nu_h, self.nu_z = nu_h, nu_z
        self.kappa_h, self.kappa_z, self.kappa_c = kappa_h, kappa_z, kappa_c
        self.f_o, self.beta = f_o, beta

        self.prog_spec = VarSpec(u=2, eta=1, theta=1)
        self.aux_spec = VarSpec(coord=3, y=1, w=1, pkin=1, wz0=1,
                                ud=2, dGu=2)
        self.grad_spec = VarSpec(u=2, theta=1)
        self.gf_spec = VarSpec(div_h_u=1, nu_grad_u=(3, 2),
                               kappa_grad_theta=3)
        self._cols = ColumnOpsCache()
        self._filters = {}

    def vars_state(self, state_type) -> VarSpec:
        if isinstance(state_type, st.UpwardIntegrals):
            return VarSpec(div_h_u=1, alpha_theta=1)
        if isinstance(state_type, st.DownwardIntegrals):
            return VarSpec(alpha_theta=1)
        return super().vars_state(state_type)

    def prog(self, q, name):
        return self.prog_spec.get(q, name)

    def aux_get(self, aux, name):
        return self.aux_spec.get(aux, name)

    # --- helpers -------------------------------------------------------------
    def _vert_filters(self, grid):
        """(cut-off on u, exponential on θ): the reference's CutoffFilter
        at Nq₃ − 2, which zeroes the top two vertical modes, and
        ExponentialFilter(Nc = 1, s = 8)."""
        key = id(grid)
        if key not in self._filters:
            self._filters[key] = (CutoffFilter(grid, Nc=grid.Nq[-1] - 2),
                                  ExponentialFilter(grid, Nc=1, s=8))
        return self._filters[key]

    # --- initialization ------------------------------------------------------
    def nodal_init_state_auxiliary(self, coords, aux, grid):
        aux = aux.clone()
        aux[:, self.aux_spec.index("y").start] = coords[:, 1]
        return self.problem.init_aux(self, coords, aux)

    def init_state_prognostic(self, coords, aux, t):
        return self.problem.init_state(self, coords, aux, t)

    # --- the stage's filters -------------------------------------------------
    @property
    def preprocess_is_identity(self) -> bool:
        return not self.apply_vert_filters

    def preprocess_state(self, dg, q, aux, t):
        """u through the vertical cut-off, θ through the vertical
        exponential filter, η as it is."""
        if not self.apply_vert_filters:
            return q
        vert_cut, exp_f = self._vert_filters(dg.grid)
        s = self.prog_spec
        out = q.clone()
        for name, filt in (("u", vert_cut), ("theta", exp_f)):
            sl = s.index(name)
            out[:, sl] = filt(q[:, sl].contiguous(), direction="vertical")
        return out

    # --- gradient pass -------------------------------------------------------
    def compute_gradient_argument(self, q, aux, t):
        s = self.prog_spec
        return torch.cat([q[:, s.index("u")], q[:, s.index("theta")]], dim=1)

    def compute_gradient_flux(self, grad_g, q, aux, t):
        """∇ʰ·u, −ν∇u and −κ∇θ, the vertical κ the convective
        adjustment's: κᶜ where ∂θ/∂z < 0, else κᶻ."""
        gs = self.grad_spec
        grad_u = grad_g[:, :, gs.index("u")]                 # [E, 3, 2, L]
        grad_th = grad_g[:, :, gs.index("theta").start]      # [E, 3, L]
        div_h_u = grad_u[:, 0, 0] + grad_u[:, 1, 1]
        nu = grad_g.new_tensor([self.nu_h, self.nu_h, self.nu_z])
        nu_grad_u = -nu[None, :, None, None] * grad_u
        dz = grad_th[:, 2]
        kz = torch.where(dz < 0, torch.full_like(dz, self.kappa_c),
                         torch.full_like(dz, self.kappa_z))
        kh = torch.full_like(dz, self.kappa_h)
        kap = torch.stack([kh, kh, kz], dim=1)
        E, L = q.shape[0], q.shape[-1]
        return torch.cat([div_h_u[:, None], nu_grad_u.reshape(E, 6, L),
                          -kap * grad_th], dim=1)

    # --- stack integrals -----------------------------------------------------
    def update_auxiliary_state_gradient(self, dg, gf, q, aux, t):
        """w = ∫_b^z −∇ʰ·u, pkin = ∫_z^0 −αᵀθ and wz0 = w(z = 0) down the
        column."""
        cols = self._cols(dg.grid)
        div_h_u = self.gf_spec.get(gf, "div_h_u")
        w = cols.indefinite_integral(-div_h_u[:, None])
        theta = self.prog(q, "theta")
        pkin = cols.reverse_indefinite_integral((-self.alpha_T * theta)[:,
                                                                         None])
        wz0 = cols.broadcast_top(w)
        sp = self.aux_spec
        aux = aux.clone()
        aux[:, sp.index("w")] = w
        aux[:, sp.index("pkin")] = pkin
        aux[:, sp.index("wz0")] = wz0
        return aux, q

    # --- fluxes --------------------------------------------------------------
    def _velocity3(self, q, aux):
        return torch.cat([self.prog(q, "u"), self.aux_spec.get(aux, "w")[
            :, None]], dim=1)

    def flux_first_order(self, q, aux, t):
        """g(η + pkin) Iʰ on u, with "nonlinear" advection v⊗u on u and
        vθ on θ."""
        s = self.prog_spec
        iu, ith = s.index("u"), s.index("theta").start
        E, n, L = q.shape
        F = q.new_zeros((E, 3, n, L))
        p = self.param_set.grav * (self.prog(q, "eta")
                                   + self.aux_get(aux, "pkin"))
        F[:, 0, iu.start] = p
        F[:, 1, iu.start + 1] = p
        if self.momentum_advection == "nonlinear" \
                or self.tracer_advection == "nonlinear":
            v = self._velocity3(q, aux)
        if self.momentum_advection == "nonlinear":
            F[:, :, iu] = F[:, :, iu] + v[:, :, None] * self.prog(
                q, "u")[:, None]
        if self.tracer_advection == "nonlinear":
            F[:, :, ith] = v * self.prog(q, "theta")[:, None]
        return F

    def flux_second_order(self, q, gf, hyper, aux, t):
        s, fs = self.prog_spec, self.gf_spec
        E, n, L = q.shape
        F = q.new_zeros((E, 3, n, L))
        F[:, :, s.index("u")] = fs.get(gf, "nu_grad_u").reshape(E, 3, 2, L)
        F[:, :, s.index("theta").start] = fs.get(gf, "kappa_grad_theta")
        return F

    # --- source --------------------------------------------------------------
    def coriolis_parameter(self, y):
        """The problem's f(y), else f₀ + βy."""
        if hasattr(self.problem, "coriolis_parameter"):
            return self.problem.coriolis_parameter(self, y)
        return self.f_o + self.beta * y

    def source(self, q, aux, t, gf=None):
        """η: w(z = 0); u: −f×u, plus the forcing."""
        s = self.prog_spec
        iu, ie, ith = (s.index("u"), s.index("eta").start,
                       s.index("theta").start)
        out = torch.zeros_like(q)
        out[:, ie] = self.aux_get(aux, "wz0")
        u = self.prog(q, "u")
        y = self.aux_get(aux, "y")
        f = self.coriolis_parameter(y)
        out[:, iu.start] = f * u[:, 1]
        out[:, iu.start + 1] = -f * u[:, 0]
        fr = self.forcing
        if any(x is not None for x in (fr.u, fr.v, fr.eta, fr.theta)):
            args = (y, t, u[:, 0], u[:, 1], self.aux_get(aux, "w"),
                    self.prog(q, "eta"), self.prog(q, "theta"))
            if fr.u is not None:
                out[:, iu.start] = out[:, iu.start] + fr.u(*args)
            if fr.v is not None:
                out[:, iu.start + 1] = out[:, iu.start + 1] + fr.v(*args)
            if fr.eta is not None:
                out[:, ie] = out[:, ie] + fr.eta(*args)
            if fr.theta is not None:
                out[:, ith] = out[:, ith] + fr.theta(*args)
        return out

    # --- numerics ------------------------------------------------------------
    def wavespeed(self, nrm, q, aux, t):
        """|n · (c_h, c_h, c_z)|."""
        return torch.abs(nrm[:, 0] * self.c_h + nrm[:, 1] * self.c_h
                         + nrm[:, 2] * self.c_z)

    def numerical_flux_penalty(self, nrm, qM, auxM, qP, auxP, dq):
        """Δη = 0: η's jump takes no Rusanov dissipation."""
        dq = dq.clone()
        dq[:, self.prog_spec.index("eta")] = 0.0
        return dq

    # --- boundary conditions -------------------------------------------------
    def boundary_conditions(self):
        return self.problem.boundary_conditions

    def boundary_state(self, tag, nrm, q_minus, aux_minus, t):
        """u's ghost by :func:`~climatemachine_tpu_torch.ocean.core.
        velocity_ghost`; w reflected at an impenetrable no-slip wall."""
        bc = self.problem.boundary_conditions[tag - 1]
        sp = self.prog_spec
        qP = q_minus.clone()
        qP[:, sp.index("u")] = oc.velocity_ghost(
            bc.velocity, nrm[:, :2], self.prog(q_minus, "u"))
        auxP = aux_minus
        if isinstance(bc.velocity, oc.Impenetrable) \
                and isinstance(bc.velocity.drag, oc.NoSlip):
            auxP = aux_minus.clone()
            iw = self.aux_spec.index("w")
            auxP[:, iw] = -aux_minus[:, iw]
        return qP, auxP

    def boundary_state_gradient_flux(self, tag, nrm, gf_minus, q_minus,
                                     aux_minus, t):
        """2·target − minus, so that the surface pass's central average
        is the reference's boundary flux D⁺: FreeSlip ν∇u⁺ = 0 (ghost
        −D⁻), NoSlip D⁺ = D⁻ (a copy), KinematicStress n⊗τ, Insulating
        κ∇θ⁺ = 0, TemperatureFlux n·f."""
        bc = self.problem.boundary_conditions[tag - 1]
        fs = self.gf_spec
        iu, ik = fs.index("nu_grad_u"), fs.index("kappa_grad_theta")
        gfP = gf_minus.clone()
        v = bc.velocity
        if isinstance(v.drag, oc.FreeSlip):
            gfP[:, iu] = -gf_minus[:, iu]
        elif isinstance(v.drag, oc.KinematicStress) and (
                v.drag.stress or getattr(self.problem, "_stress", None)):
            stress = v.drag.stress or self.problem._stress
            y = self.aux_get(aux_minus, "y")
            tau = stress(self.problem, y, t)                  # [E, 2, X]
            target = (nrm[:, :, None] * tau[:, None]).reshape(gfP[:,
                                                                  iu].shape)
            gfP[:, iu] = 2 * target - gf_minus[:, iu]
        tbc = bc.temperature
        if isinstance(tbc, oc.Insulating):
            gfP[:, ik] = -gf_minus[:, ik]
        elif isinstance(tbc, oc.TemperatureFlux) and tbc.flux:
            y = self.aux_get(aux_minus, "y")
            theta = self.prog(q_minus, "theta")
            target = nrm * tbc.flux(self.problem, y, theta, t)[:, None]
            gfP[:, ik] = 2 * target - gf_minus[:, ik]
        return gfP


HBModel = HydrostaticBoussinesqModel


class LinearHBModel(BalanceLaw):
    """The ocean's linearization for a vertically implicit step: the
    surface-pressure coupling g η Iʰ and the viscous fluxes, no
    advection, no pkin."""

    def __init__(self, ocean: HydrostaticBoussinesqModel):
        self.ocean = ocean
        self.prog_spec, self.aux_spec = ocean.prog_spec, ocean.aux_spec
        self.grad_spec, self.gf_spec = ocean.grad_spec, ocean.gf_spec

    def vars_state(self, state_type):
        return self.ocean.vars_state(state_type)

    def compute_gradient_argument(self, q, aux, t):
        return self.ocean.compute_gradient_argument(q, aux, t)

    def compute_gradient_flux(self, grad_g, q, aux, t):
        return self.ocean.compute_gradient_flux(grad_g, q, aux, t)

    def flux_second_order(self, q, gf, hyper, aux, t):
        return self.ocean.flux_second_order(q, gf, hyper, aux, t)

    def flux_first_order(self, q, aux, t):
        o = self.ocean
        iu = o.prog_spec.index("u").start
        E, n, L = q.shape
        F = q.new_zeros((E, 3, n, L))
        p = o.param_set.grav * o.prog(q, "eta")
        F[:, 0, iu] = p
        F[:, 1, iu + 1] = p
        return F

    def wavespeed(self, nrm, q, aux, t):
        return self.ocean.wavespeed(nrm, q, aux, t)

    def boundary_conditions(self):
        return self.ocean.boundary_conditions()

    def boundary_state(self, tag, nrm, q_minus, aux_minus, t):
        return self.ocean.boundary_state(tag, nrm, q_minus, aux_minus, t)

    def boundary_state_gradient_flux(self, *args):
        return self.ocean.boundary_state_gradient_flux(*args)
