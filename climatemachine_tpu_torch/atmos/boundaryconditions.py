"""Atmosphere boundary conditions (port of
``climatemachine_tpu/atmos/boundaryconditions.py``, the whole module,
and of the ``_bc_value`` helper of ``climatemachine_tpu/atmos/model.py``
:39).

An ``AtmosBC`` bundles one condition per equation: momentum
``Impenetrable(FreeSlip())``, ``NoSlip()`` or ``DragLaw(C)``, energy
``Insulating()``, ``PrescribedTemperature``, ``BulkFormulaEnergy`` or
``PrescribedEnergyFlux``, moisture ``Impermeable()``,
``PrescribedMoistureFlux`` or ``BulkFormulaMoisture``.  It gives the
ghost state of the first-order numerical flux and of the gradient pass
(:meth:`AtmosBC.ghost_state`): free slip reflects the normal momentum,
no slip negates it, a prescribed temperature sets ρe, the rest is
copied.  The prescribed diffusive wall fluxes (drag, bulk formulas,
prescribed fluxes) are the model's ``boundary_flux_second_order``
(atmos/model.py).  ``InitStateBC`` takes the problem's initial condition
at the wall as the ghost.

The var-major RHS (dg/fast_rhs.py) and the var-major surface pass
(dg/fast_surface.py) build the impenetrable free-slip, insulating,
impermeable wall's ghost themselves and take no other
(:meth:`AtmosBC.is_free_slip_wall`).  Face data is var-major: q ``[E, n,
X]``, normals and ρu ``[E, 3, X]``.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field

import torch


def _bc_value(v, model, q, aux, t, speed=None):
    """A bulk-formula coefficient: a constant as it is; a callable as
    f(t), f(model, q, aux, t) or f(model, q, aux, t, speed), by the
    number of its positional parameters without defaults."""
    if not callable(v):
        return v
    try:
        params = list(inspect.signature(v).parameters.values())
        # count only positional parameters without defaults; *args or
        # defaulted extras must not change the dispatch arity
        n = sum(1 for p in params
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is p.empty)
        if any(p.kind is p.VAR_POSITIONAL for p in params):
            n = 5
    except (TypeError, ValueError):
        n = None
    if n is not None:
        if n >= 5:
            return v(model, q, aux, t, speed)
        if n >= 4:
            return v(model, q, aux, t)
        if n <= 1:
            return v(t)
    # uninspectable or ambiguous arity: try decreasing arity
    for args in ((model, q, aux, t, speed), (model, q, aux, t), (t,)):
        try:
            return v(*args)
        except TypeError:
            continue
    raise TypeError(
        f"bulk-BC coefficient {v!r} must accept (t), (model, q, aux, t) "
        "or (model, q, aux, t, speed)")


# --- momentum ---------------------------------------------------------------

class MomentumBC:
    def ghost_rhou(self, model, nrm, rhou, aux, t):
        raise NotImplementedError


class FreeSlip(MomentumBC):
    """Reflect the normal momentum."""

    def ghost_rhou(self, model, nrm, rhou, aux, t):
        un = torch.sum(rhou * nrm, dim=1, keepdim=True)
        return rhou - 2 * un * nrm


class NoSlip(MomentumBC):
    """Negate the momentum."""

    def ghost_rhou(self, model, nrm, rhou, aux, t):
        return -rhou


@dataclass(frozen=True)
class DragLaw(MomentumBC):
    """Bulk drag with coefficient ``C_drag`` (a constant or a callable,
    :func:`_bc_value`): the ghost is free slip, the drag enters as the
    diffusive wall flux."""
    C_drag: object

    def ghost_rhou(self, model, nrm, rhou, aux, t):
        return FreeSlip().ghost_rhou(model, nrm, rhou, aux, t)


@dataclass(frozen=True)
class Impenetrable(MomentumBC):
    """No normal flow; the tangential behaviour from ``bc``."""
    bc: MomentumBC = field(default_factory=FreeSlip)

    def ghost_rhou(self, model, nrm, rhou, aux, t):
        return self.bc.ghost_rhou(model, nrm, rhou, aux, t)


# --- energy -----------------------------------------------------------------

class EnergyBC:
    def ghost_rhoe(self, model, nrm, q, aux, rhou_ghost, t):
        """ρe copied (insulating at first order)."""
        return model.prog_spec.get(q, "rhoe")


class Insulating(EnergyBC):
    pass


@dataclass(frozen=True)
class BulkFormulaEnergy(EnergyBC):
    """Bulk surface energy flux C_h |u_t| (h − h_sfc); ``C_h`` and
    ``T_sfc`` constants or callables (:func:`_bc_value`)."""
    C_h: object = 1e-3
    T_sfc: object = 300.0


@dataclass(frozen=True)
class PrescribedEnergyFlux(EnergyBC):
    """Net inward energy flux ``fn(model, q, aux, t)`` [W/m²] or a
    constant; insulating at first order."""
    fn: object = 0.0


@dataclass(frozen=True)
class PrescribedTemperature(EnergyBC):
    """Dirichlet surface temperature ``T_sfc`` (a constant or a callable
    of t): the ghost ρe = ρ(c_v (T_sfc − T_0) + |ρu_g|²/2ρ² + Φ)."""
    T_sfc: object

    def ghost_rhoe(self, model, nrm, q, aux, rhou_ghost, t):
        ps = model.param_set
        rho = model.prog_spec.get(q, "rho")
        Phi = model.aux_spec.get(aux, "orientation.Phi")
        T = self.T_sfc(t) if callable(self.T_sfc) else self.T_sfc
        e_int = ps.cv_d * (T - ps.T_0)
        ke = 0.5 * torch.sum(rhou_ghost ** 2, dim=1) / rho ** 2
        return rho * (e_int + ke + Phi)


# --- moisture ---------------------------------------------------------------

class MoistureBC:
    pass


class Impermeable(MoistureBC):
    """No moisture wall flux."""


@dataclass(frozen=True)
class PrescribedMoistureFlux(MoistureBC):
    """Net inward moisture flux ``fn(model, q, aux, t)`` [kg/m²/s]."""
    fn: object


@dataclass(frozen=True)
class BulkFormulaMoisture(MoistureBC):
    """Bulk moisture flux C_q ρ |u_t| (q_sfc − q_int); ``q_tot_sfc`` a
    constant or a callable (:func:`_bc_value`)."""
    C_q: object = 1e-3
    q_tot_sfc: object = 0.0


# --- composed ---------------------------------------------------------------

@dataclass(frozen=True)
class AtmosBC:
    momentum: MomentumBC = field(
        default_factory=lambda: Impenetrable(FreeSlip()))
    energy: EnergyBC = field(default_factory=Insulating)
    moisture: MoistureBC = field(default_factory=Impermeable)

    def is_free_slip_wall(self) -> bool:
        """The impenetrable free-slip, insulating, impermeable wall, the
        one the var-major passes build themselves."""
        mom = self.momentum
        if isinstance(mom, Impenetrable):
            mom = mom.bc
        return (type(mom) is FreeSlip and type(self.energy) is Insulating
                and type(self.moisture) is Impermeable)

    def ghost_state(self, model, nrm, q, aux, t):
        """(q_ghost, aux) on var-major face lanes: ρu from the momentum
        condition, ρe from the energy condition, every other lane
        copied (ρ, ρq_tot, the precipitation and tracer lanes)."""
        sp = model.prog_spec
        rhou_g = self.momentum.ghost_rhou(model, nrm, sp.get(q, "rhou"),
                                          aux, t)
        rhoe_g = self.energy.ghost_rhoe(model, nrm, q, aux, rhou_g, t)
        qg = q.clone()
        qg[:, sp.index("rhou")] = rhou_g
        qg[:, sp.index("rhoe").start] = rhoe_g
        return qg, aux


@dataclass(frozen=True)
class InitStateBC:
    """The ghost state is the problem's ``init_state`` at the wall nodes
    and time; the gradient-flux ghost stays the minus side."""

    def is_free_slip_wall(self) -> bool:
        return False

    def ghost_state(self, model, nrm, q, aux, t):
        coords = model.aux_spec.get(aux, "coord")
        return model.problem.init_state(model, coords, aux, t), aux
