"""The 2-D barotropic shallow-water model (port of
``climatemachine_tpu/ocean/shallow_water.py``: ``LinearDrag`` :23,
``ConstantViscosity`` :28, ``ShallowWaterModel`` :32-144).

  ∂η/∂t + ∇·U = 0
  ∂U/∂t + ∇·(gHη Iʰ + U⊗U/H) = −f×U + τ − λU + ∇·(ν∇U)

with the transport U = ∫u dz, the problem's f(y) and kinematic stress τ,
the linear drag λ (``LinearDrag``) or the viscosity ν
(``ConstantViscosity``, the default, with ν = 0), and U⊗U/H only with
``advection="nonlinear"``.  A :class:`~climatemachine_tpu_torch.
balance_laws.interface.BalanceLaw` on a 2-D grid (fluxes ``[E, 2, n,
L]``), on the generic DG operator, plain PyTorch as the JAX package
leaves it to XLA.  Lanes, var-major ``[E, n, L]``: prognostic η, U[0],
U[1]; aux coord(2), y, GU(2), du(2); with ConstantViscosity gradient
U(2), gradient flux ν∇U (2 × 2, direction i then component c at 2i +
c).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from climatemachine_tpu_torch.balance_laws.interface import BalanceLaw
from climatemachine_tpu_torch.ocean import core as oc
from climatemachine_tpu_torch.physics.parameters import (EARTH,
                                                         PlanetParameterSet)
from climatemachine_tpu_torch.utils.variables import VarSpec


@dataclass
class LinearDrag:
    lam: float


@dataclass
class ConstantViscosity:
    nu: float


class ShallowWaterModel(BalanceLaw):
    """The barotropic model; ``c`` is the Rusanov wave speed, ``f_o`` and
    ``beta`` the β-plane the problem's ``coriolis_parameter`` reads."""

    def __init__(self, problem, param_set: PlanetParameterSet = EARTH,
                 turbulence=None, advection="nonlinear", c=0.0,
                 coupling=None, f_o=1e-4, beta=1e-11):
        self.problem = problem
        self.param_set = param_set
        self.turbulence = turbulence or ConstantViscosity(0.0)
        self.advection = advection
        self.c = c
        self.coupling = coupling or oc.Uncoupled()
        self.f_o, self.beta = f_o, beta

        self.prog_spec = VarSpec(eta=1, U=2)
        self.aux_spec = VarSpec(coord=2, y=1, GU=2, du=2)
        visc = isinstance(self.turbulence, ConstantViscosity)
        self.grad_spec = VarSpec(U=2) if visc else VarSpec()
        self.gf_spec = VarSpec(nu_grad_U=(2, 2)) if visc else VarSpec()

    def prog(self, q, name):
        return self.prog_spec.get(q, name)

    def aux_get(self, aux, name):
        return self.aux_spec.get(aux, name)

    # --- initialization ------------------------------------------------------
    def nodal_init_state_auxiliary(self, coords, aux, grid):
        aux = aux.clone()
        aux[:, self.aux_spec.index("y").start] = coords[:, 1]
        if hasattr(self.problem, "init_aux"):
            aux = self.problem.init_aux(self, coords, aux)
        return aux

    def init_state_prognostic(self, coords, aux, t):
        return self.problem.init_state(self, coords, aux, t)

    # --- fluxes --------------------------------------------------------------
    def flux_first_order(self, q, aux, t):
        """U on η; gHη Iʰ, plus U⊗U/H with "nonlinear" advection, on U."""
        s = self.prog_spec
        ie, iU = s.index("eta").start, s.index("U").start
        E, n, L = q.shape
        H = self.problem.H
        U = self.prog(q, "U")
        F = q.new_zeros((E, 2, n, L))
        F[:, :, ie] = U
        p = self.param_set.grav * H * self.prog(q, "eta")
        F[:, 0, iU] = p
        F[:, 1, iU + 1] = p
        if self.advection == "nonlinear":
            F[:, :, iU:iU + 2] = F[:, :, iU:iU + 2] + (
                U[:, :, None] * U[:, None, :] / H)
        return F

    def compute_gradient_argument(self, q, aux, t):
        return self.prog(q, "U").clone()

    def compute_gradient_flux(self, grad_g, q, aux, t):
        """−ν∇U, lanes 2i + c."""
        E, L = q.shape[0], q.shape[-1]
        return (-self.turbulence.nu * grad_g).reshape(E, 4, L)

    def flux_second_order(self, q, gf, hyper, aux, t):
        s = self.prog_spec
        E, n, L = q.shape
        F = q.new_zeros((E, 2, n, L))
        F[:, :, s.index("U")] = self.gf_spec.get(gf, "nu_grad_U").reshape(
            E, 2, 2, L)
        return F

    # --- source --------------------------------------------------------------
    def _coriolis(self, q, aux):
        """−f×U ``[E, 2, L]``."""
        U = self.prog(q, "U")
        f = self.problem.coriolis_parameter(self, self.aux_get(aux, "y"))
        return torch.stack([f * U[:, 1], -f * U[:, 0]], dim=1)

    def source(self, q, aux, t, gf=None):
        """U: −f×U, plus the problem's kinematic stress, less λU with
        LinearDrag."""
        su = self._coriolis(q, aux)
        if hasattr(self.problem, "kinematic_stress"):
            su = su + self.problem.kinematic_stress(self.aux_get(aux, "y"))
        if isinstance(self.turbulence, LinearDrag):
            su = su - self.turbulence.lam * self.prog(q, "U")
        out = torch.zeros_like(q)
        out[:, self.prog_spec.index("U")] = su
        return out

    def wavespeed(self, nrm, q, aux, t):
        return q.new_full((q.shape[0], q.shape[-1]), self.c)

    # --- boundary conditions -------------------------------------------------
    def boundary_conditions(self):
        return self.problem.boundary_conditions

    def boundary_state(self, tag, nrm, q_minus, aux_minus, t):
        """U's ghost by :func:`~climatemachine_tpu_torch.ocean.core.
        velocity_ghost` of the condition's velocity."""
        bc = self.problem.boundary_conditions[tag - 1]
        qP = q_minus.clone()
        iU = self.prog_spec.index("U")
        qP[:, iU] = oc.velocity_ghost(bc.velocity, nrm[:, :2],
                                      self.prog(q_minus, "U"))
        return qP, aux_minus

    def boundary_state_gradient_flux(self, tag, nrm, gf_minus, q_minus,
                                     aux_minus, t):
        """A free-slip wall reflects ν∇U, any other copies it."""
        bc = self.problem.boundary_conditions[tag - 1]
        if self.gf_spec.num and isinstance(bc.velocity.drag, oc.FreeSlip):
            return -gf_minus
        return gf_minus
