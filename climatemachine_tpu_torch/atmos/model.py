"""The atmosphere balance law (port of ``climatemachine_tpu/atmos/model.py``
for the Held-Suarez step, the moist baroclinic wave with its tracers and
warm rain, and the LES boxes with their forcings: ``AtmosPhysics`` :76
with ``turbulence`` :82, ``tracers`` :84, ``precipitation`` :86,
``viscoussponge`` :87, ``sgstke`` :88, ``lsforcing`` :94 and
``radiation`` :96 (the SGS TKE lane :155-158, gradient lanes :216-223,
fluxes :437-438, :441-446, :564-565, source :585-588; the large-scale
forcing's aux :184-189 and ``init_aux`` :350-351; radiation's aux
:192-194 and its stack integrals after the nodal update :482-490),
the prognostic/aux/gradient schemas :143-233, ``thermo_full`` :274,
``nodal_init_state_auxiliary`` :334 (the closure's lengthscale
:346-347), the thermo refresh of the aux lanes through the moisture
model (``nodal_update_auxiliary_state`` :493), and the hooks of the
generic DG operator for the total-energy, compressible model:
``flux_first_order`` :372-447 (the advected moisture, precipitation and
tracer scalars :419-437), ``wavespeed`` :449, the gradient hooks
``compute_gradient_argument`` / ``compute_gradient_flux`` :502-537, the
gradient-Laplacian hooks :539-550, ``flux_second_order`` :552-580 (the
closure's viscous flux with the moisture's and tracers' diffusion, and
hyperdiffusion), ``source`` :583-605, the wall ghost ``boundary_state``
:608-618, the wall fluxes ``boundary_flux_second_order`` :620-694, and
the balance law's defaults ``boundary_state_gradient_flux`` and
``update_auxiliary_state_gradient``
(``climatemachine_tpu/balance_laws/interface.py`` :112-115, :133-139)).

Prognostic, in the JAX package's order: ρ, ρu(3), ρe, then with
``EquilMoist`` ρq_tot (``NonEquilMoist``: ρq_tot, ρq_liq, ρq_ice), with
a precipitation model ρq_rai (and ρq_sno), with ``NTracers`` ρχ (N),
with ``sgstke`` ρe_SGS.  Auxiliary: coord(3), orientation (Φ, ∇Φ),
with a ``HydrostaticState`` the reference state (ρ, p, T, ρe), with a
turbulence closure that needs it ``turbulence.delta``, moisture (θ_v, T
dry; T, θ_v, q_liq, q_ice with ``EquilMoist``; T, θ_v with
``NonEquilMoist``), then, with hyperdiffusion, ``hyperdiffusion.delta``,
with a large-scale forcing its profile, with radiation its attenuation
paths.  With a turbulence closure the model has gradient lanes (the
closure's u, h_tot[, θ_v], then ``moisture.q_tot``, ``tracers.chi``,
``sgstke.e_SGS``, ``sgstke.theta_li``, ``lsforcing.ta``,
``lsforcing.hus``) and gradient-flux lanes (the closure's, then
``moisture.d_q_tot``, ``tracers.d_chi``, ``sgstke.d_e_SGS``,
``sgstke.d_theta_li``, ``lsforcing.dz_ta``, ``lsforcing.dz_hus``).
State and aux are var-major ``[E, n, L]`` over L nodes (volume or face
lanes); fluxes ``[E, 3, n, L]`` (direction i, then variable); gradients
``[E, 3, ng, L]``; gradient fluxes ``[E, ngf, L]``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple

import torch

from climatemachine_tpu_torch.atmos import boundaryconditions as abc
from climatemachine_tpu_torch.atmos.boundaryconditions import (AtmosBC,
                                                               _bc_value)
from climatemachine_tpu_torch.atmos.moisture import DryModel, EquilMoist
from climatemachine_tpu_torch.atmos.ref_state import (NoReferenceState,
                                                     ReferenceState)
from climatemachine_tpu_torch.atmos.sources import VMContext
from climatemachine_tpu_torch.atmos.tracers import NoTracers
from climatemachine_tpu_torch.balance_laws.interface import BalanceLaw
from climatemachine_tpu_torch.balance_laws.show_tendencies import \
    show_tendencies
from climatemachine_tpu_torch.common.orientations import (FlatOrientation,
                                                          Orientation)
from climatemachine_tpu_torch.dg.columns import ColumnOpsCache
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import (EARTH,
                                                         PlanetParameterSet)
from climatemachine_tpu_torch.utils.variables import VarSpec


@dataclass(frozen=True)
class AtmosPhysics:
    """Physics bundle.  ``moisture`` is a
    :class:`~climatemachine_tpu_torch.atmos.moisture.DryModel` or an
    :class:`~climatemachine_tpu_torch.atmos.moisture.EquilMoist`; the
    orientation defaults to ``FlatOrientation`` and the reference state
    to ``NoReferenceState``, as in the JAX package; ``hyperdiffusion`` is
    None, a
    :class:`~climatemachine_tpu_torch.atmos.hyperdiffusion.DryBiharmonic`
    or, with ``EquilMoist``, an ``EquilMoistBiharmonic`` (the var-major
    RHS refuses any other kind); ``tracers`` None or an
    :class:`~climatemachine_tpu_torch.atmos.tracers.NTracers`;
    ``precipitation`` None or a model of
    :mod:`climatemachine_tpu_torch.atmos.precipitation`; ``turbulence``
    None or a closure of :mod:`climatemachine_tpu_torch.common.turbulence`
    (it brings the gradient pass); ``viscoussponge`` None or an
    ``UpperAtmosSponge``; ``sgstke`` None or an
    :class:`~climatemachine_tpu_torch.atmos.sgstke.SGStkeModel` (with a
    closure, ``Deardorff`` for its viscosity); ``lsforcing`` None or a
    model of :mod:`climatemachine_tpu_torch.atmos.lsforcing` (with a
    closure); ``radiation`` None or a model of
    :mod:`climatemachine_tpu_torch.atmos.radiation`.  ``turbconv`` (EDMF)
    is not ported: the model refuses it."""
    param_set: PlanetParameterSet = EARTH
    orientation: Orientation = field(default_factory=FlatOrientation)
    ref_state: ReferenceState = field(default_factory=NoReferenceState)
    turbulence: Optional[object] = None
    hyperdiffusion: Optional[object] = None
    moisture: object = field(default_factory=DryModel)
    tracers: Optional[object] = None
    precipitation: Optional[object] = None
    viscoussponge: Optional[object] = None
    sgstke: Optional[object] = None
    lsforcing: Optional[object] = None
    turbconv: Optional[object] = None
    radiation: Optional[object] = None


#: the AtmosPhysics fields not ported, with the slice each waits for
_NOT_PORTED = {"turbconv": "EDMF (atmos/edmf.py)"}


@dataclass(frozen=True)
class AtmosProblem:
    """Initial condition ``(model, coords, aux, t) -> q`` (var-major) and
    one boundary condition per boundary tag."""
    init_state: Callable = None
    boundary_conditions: Tuple[AtmosBC, ...] = (AtmosBC(), AtmosBC())


def _set(arr, sl: slice, val):
    """Copy of ``arr`` with var-major slots ``sl`` replaced by ``val``."""
    out = arr.clone()
    out[:, sl] = val.reshape(out[:, sl].shape)
    return out


class AtmosModel(BalanceLaw):
    """Compressible atmosphere with total energy, dry or moist, with
    passive tracers, precipitation, SGS TKE, large-scale forcing and
    radiation (a :class:`BalanceLaw` whose hooks override the base's)."""

    def __init__(self, physics: AtmosPhysics, problem: AtmosProblem,
                 sources: Sequence = ()):
        for name, what in _NOT_PORTED.items():
            if getattr(physics, name) is not None:
                raise NotImplementedError(f"next slice: {what}")
        self.physics = physics
        self.problem = problem
        self.sources = tuple(sources)
        moist = physics.moisture
        self.tracers = physics.tracers or NoTracers()
        #: the precipitation model with prognostic lanes, else None
        self.precipitation = (
            physics.precipitation if physics.precipitation is not None
            and physics.precipitation.vars_prognostic().num else None)
        prog_fields = dict(rho=1, rhou=3, rhoe=1)
        if moist.vars_prognostic().num:
            prog_fields["moisture"] = moist.vars_prognostic()
        if self.precipitation is not None:
            prog_fields["precipitation"] = \
                self.precipitation.vars_prognostic()
        if self.tracers.N:
            prog_fields["tracers"] = self.tracers.vars_prognostic()
        turb = physics.turbulence
        for name in ("sgstke", "lsforcing"):
            if getattr(physics, name) is not None and turb is None:
                raise ValueError(f"{name} needs a turbulence closure (the "
                                 "gradient pass)")
        if physics.sgstke is not None:
            prog_fields["sgstke"] = physics.sgstke.vars_prognostic()
        self.prog_spec = VarSpec(**prog_fields)
        aux_fields = dict(coord=3,
                          orientation=physics.orientation.vars_aux())
        #: aux carries the reference state's lanes
        self.has_ref_state = bool(physics.ref_state.vars_aux().num)
        if self.has_ref_state:
            aux_fields["ref_state"] = physics.ref_state.vars_aux()
        if turb is not None and turb.vars_aux().num:
            aux_fields["turbulence"] = turb.vars_aux()
        aux_fields["moisture"] = moist.vars_aux()
        hyper = physics.hyperdiffusion
        if hyper is not None:
            aux_fields["hyperdiffusion"] = hyper.vars_aux()
        for name in ("lsforcing", "radiation"):
            part = getattr(physics, name)
            if part is not None and part.vars_aux().num:
                aux_fields[name] = part.vars_aux()
        self.aux_spec = VarSpec(**aux_fields)
        self.column_ops = ColumnOpsCache()
        self.gradlap_spec = (hyper.vars_gradient_laplacian()
                             if hyper is not None else VarSpec())
        self.hyperdiffusion_direction = (hyper.direction
                                         if hyper is not None else None)
        # the gradient pass runs with a turbulence closure (its diffusivity
        # D_t also diffuses the moisture and the tracers)
        gfields, gffields = {}, {}
        if turb is not None:
            gfields = turb.vars_gradient().field_dict()
            gffields = turb.vars_gradient_flux().field_dict()
            for name, part in (("moisture", moist),
                               ("tracers", self.tracers),
                               ("sgstke", physics.sgstke),
                               ("lsforcing", physics.lsforcing)):
                if part is not None and part.vars_gradient().num:
                    gfields[name] = part.vars_gradient()
                    gffields[name] = part.vars_gradient_flux()
        self.grad_spec = VarSpec(**gfields)
        self.gf_spec = VarSpec(**gffields)

    @property
    def param_set(self) -> PlanetParameterSet:
        return self.physics.param_set

    @property
    def ref_state(self) -> ReferenceState:
        return self.physics.ref_state

    def nodal_init_state_auxiliary(self, coords, aux, grid):
        """Fill Φ, ∇Φ and a hydrostatic reference state from coords
        ``[E, 3, Np]``, and the hyperdiffusion lengthscale from the grid's
        metrics."""
        ps, sp = self.param_set, self.aux_spec
        ori = self.physics.orientation
        Phi = ori.geopotential(ps, coords)
        aux = _set(aux, sp.index("orientation.Phi"), Phi)
        aux = _set(aux, sp.index("orientation.grad_Phi"),
                   ori.grad_geopotential(ps, coords))
        if self.has_ref_state:
            for name, val in self.ref_state.fields(ps, Phi / ps.grav,
                                                   Phi).items():
                aux = _set(aux, sp.index(f"ref_state.{name}"), val)
        if self.physics.turbulence is not None:
            aux = self.physics.turbulence.init_aux(self, grid, aux)
        if self.physics.hyperdiffusion is not None:
            aux = self.physics.hyperdiffusion.init_aux(self, grid, aux)
        if self.physics.lsforcing is not None:
            aux = self.physics.lsforcing.init_aux(self, Phi / ps.grav, aux)
        return aux

    def init_state_prognostic(self, coords, aux, t):
        return self.problem.init_state(self, coords, aux, t)

    @property
    def moist(self) -> bool:
        """True with equilibrium moisture (prognostic ρq_tot)."""
        return isinstance(self.physics.moisture, EquilMoist)

    def thermo(self, q, aux):
        """(T, p) from the moisture model: the dry state's from e_int =
        ρe/ρ − |ρu|²/2ρ² − Φ; ``EquilMoist``'s from the aux lane
        ``moisture.temperature`` and its phase partition."""
        return self.physics.moisture.thermo(self, q, aux)[:2]

    def thermo_full(self, q, aux):
        """(T, p, u ``[E, 3, L]``, the phase partition or None)."""
        T, p, pp = self.physics.moisture.thermo(self, q, aux)
        return T, p, q[:, 1:4] / q[:, :1], pp

    def update_auxiliary_state(self, q, aux, grid):
        """Refresh the moisture model's thermo lanes from the state (θ_v
        and T dry; T by saturation adjustment, θ_v, q_liq and q_ice with
        ``EquilMoist``), then radiation's stack integrals."""
        aux = self.physics.moisture.update_aux(self, q, aux)
        rad = self.physics.radiation
        if rad is not None and hasattr(rad, "update_aux_integrals"):
            aux = rad.update_aux_integrals(self, grid, q, aux)
        return aux

    def show_tendencies(self) -> str:
        """The equation table: each prognostic variable's fluxes and
        sources (balance_laws/show_tendencies.py)."""
        return show_tendencies(self)

    def vertical_unit(self, aux):
        """k̂ ``[E, 3, L]`` from the aux lane ∇Φ."""
        return self.physics.orientation.vertical_unit_vector(
            self.param_set, self.aux_spec.get(aux, "orientation.grad_Phi"))

    def preprocess_state(self, dg, q, aux, t):
        """The state projection before each stage: none for this model."""
        return q

    # --- the generic DG operator's hooks ---------------------------------------
    def flux_first_order(self, q, aux, t):
        """Advection, the pressure gradient (with the reference pressure
        taken out where the reference state's ``subtract_off`` says so),
        and the pressure work: F_i[ρ] = ρu_i, F_i[ρu_j] = ρu_i u_j +
        (p − p_ref) δ_ij, F_i[ρe] = (ρe + p) u_i, each advected scalar
        (ρq_tot, ρq_rai, ρχ, ρe_SGS) F_i[ρχ] = ρχ u_i, the
        precipitation's sedimentation on its lanes, and radiation's
        energy flux on ρe."""
        rho, rhou, rhoe = q[:, 0], q[:, 1:4], q[:, 4]
        _, p = self.thermo(q, aux)
        u = rhou / rho[:, None]
        p_eff = p
        if self.ref_state.subtract_off:
            p_eff = p - self.aux_spec.get(aux, "ref_state.p")
        E, n, L = q.shape
        F = torch.empty((E, 3, n, L), dtype=q.dtype, device=q.device)
        F[:, :, 0] = rhou
        F[:, :, 1:4] = rhou[:, :, None] * u[:, None, :]
        for i in range(3):
            F[:, i, 1 + i] += p_eff
        F[:, :, 4] = (rhoe + p)[:, None] * u
        for v in range(5, n):
            F[:, :, v] = q[:, v, None] * u
        if self.precipitation is not None:
            F = self.precipitation.flux_first_order(self, q, aux, F, u)
        rad = self.physics.radiation
        if rad is not None and hasattr(rad, "energy_flux"):
            F[:, :, 4] += rad.energy_flux(self, q, aux)
        return F

    def wavespeed(self, nrm, q, aux, t):
        """|u·n| + the sound speed, ``[E, L]``."""
        T, _, pp = self.physics.moisture.thermo(self, q, aux)
        u = q[:, 1:4] / q[:, :1]
        return torch.abs(torch.sum(u * nrm, dim=1)) + td.soundspeed_air(
            self.param_set, T, pp)

    def nondiffusive_courant(self, q, aux, dt, delta_x, direction="every"):
        """(|u| + c) dt / Δx per node, |u| the speed along the direction
        ("vertical": along ∇Φ; "horizontal": across it), c the dry sound
        speed (JAX dg/courant.py ``nondiffusive_courant``)."""
        T, _, u, _ = self.thermo_full(q, aux)
        if direction == "every":
            speed = torch.linalg.vector_norm(u, dim=1)
        else:
            k = (self.aux_spec.get(aux, "orientation.grad_Phi")
                 / self.param_set.grav)
            un = torch.sum(u * k, dim=1, keepdim=True)
            speed = (torch.abs(un[:, 0]) if direction == "vertical"
                     else torch.linalg.vector_norm(u - un * k, dim=1))
        return (speed + td.soundspeed_air(self.param_set, T)) * dt / delta_x

    def compute_gradient_laplacian_argument(self, q, aux, t):
        return self.physics.hyperdiffusion.gradient_laplacian_argument(
            self, q, aux, t)

    def transform_post_gradient_laplacian(self, grad_lap, q, aux, t):
        return self.physics.hyperdiffusion.transform(self, grad_lap, q, aux, t)

    def _gradient_parts(self):
        ph = self.physics
        return [part for part in (ph.moisture, self.tracers, ph.sgstke,
                                  ph.lsforcing) if part is not None]

    def compute_gradient_argument(self, q, aux, t):
        """The gradient arguments ``[E, ng, L]``: the closure's (u, h_tot[,
        θ_v]), the moisture's q_tot, the tracers' χ, the SGS TKE's e_SGS
        and θ_li, the large-scale forcing's ta and hus."""
        out = self.physics.turbulence.gradient_argument(self, q, aux, t)
        for part in self._gradient_parts():
            out = part.gradient_argument(self, q, aux, t, out)
        return out

    def compute_gradient_flux(self, grad_g, q, aux, t):
        """The gradient flux ``[E, ngf, L]`` of the gradient ``grad_g``
        ``[E, 3, ng, L]``."""
        out = self.physics.turbulence.gradient_flux(self, grad_g, q, aux, t)
        for part in self._gradient_parts():
            out = part.gradient_flux(self, grad_g, q, aux, t, out)
        return out

    def flux_second_order(self, q, gf, hyper, aux, t):
        """F₂ ``[E, 3, n, L]``: with a gradient flux ``gf`` the closure's
        viscous flux and, with its diffusivity D_t, the moisture's and
        the tracers' diffusive fluxes, and the SGS TKE's −2ρν∇e_SGS
        (ν without the sponge's amplification, as in the JAX package);
        with a hyper state the hyperdiffusive flux."""
        F = torch.zeros((q.shape[0], 3) + q.shape[1:], dtype=q.dtype,
                        device=q.device)
        turb = self.physics.turbulence
        if turb is not None and gf is not None:
            F = F + turb.flux(self, q, gf, aux, t)
            _, D_t = turb.viscosity(self, q, gf, aux, t)
            F = self.physics.moisture.flux_second_order(self, q, gf, aux,
                                                        D_t, F)
            F = self.tracers.flux_second_order(self, q, gf, aux, D_t, F)
            if self.physics.sgstke is not None:
                nu, _ = turb.viscosity(self, q, gf, aux, t)
                F = self.physics.sgstke.flux_second_order(self, q, gf, aux,
                                                          nu, F)
        if hyper is not None:
            F = self.physics.hyperdiffusion.flux(self, q, hyper, aux, F)
        return F

    def update_auxiliary_state_gradient(self, dg, gf, q, aux, t):
        """The aux update that reads the gradient flux: none for this
        model.  Returns (aux, q)."""
        return aux, q

    def source_context(self, q, aux, thermo=None, gf=None) -> VMContext:
        """The sources' view of state q, aux and the gradient flux ``gf``
        (None without a closure); ``thermo`` is (T, p) when the caller
        has computed it (the var-major RHS: no phase partition), else the
        moisture model's thermo gives T, p and the phase partition."""
        pp = None
        if thermo is None:
            T, p, pp = self.physics.moisture.thermo(self, q, aux)
        else:
            T, p = thermo
        sp, ap = self.prog_spec, self.aux_spec
        return VMContext(rho=sp.get(q, "rho"), rhou=sp.get(q, "rhou"), T=T,
                         p=p, grad_Phi=ap.get(aux, "orientation.grad_Phi"),
                         coords=ap.get(aux, "coord"),
                         aux=lambda name: ap.get(aux, name), q=q, pp=pp,
                         gf=gf)

    def sum_sources(self, ctx: VMContext, t, out=None):
        """Σ of the sources' ``contributions_vm``, ``[E, n, Np]``, added to
        ``out`` (in place) where given."""
        if out is None:
            out = torch.zeros((ctx.rho.shape[0], self.prog_spec.num,
                               ctx.rho.shape[1]), dtype=ctx.rho.dtype,
                              device=ctx.rho.device)
        for src in self.sources:
            for name, val in src.contributions_vm(self, ctx, t).items():
                sl = self.prog_spec.index(name)
                out[:, sl] += val if val.dim() == 3 else val[:, None]
        return out

    def source(self, q, aux, t, gf=None):
        """The SGS TKE's production and dissipation on ρe_SGS (with a
        gradient flux), then Σ of the sources at (q, aux, ``gf``)."""
        out = torch.zeros_like(q)
        sg = self.physics.sgstke
        if sg is not None:
            out[:, self.prog_spec.index("sgstke.rhoe_SGS").start] += \
                sg.source(self, q, gf, aux, t)
        return self.sum_sources(self.source_context(q, aux, gf=gf), t, out)

    def boundary_state(self, tag: int, nrm, q_minus, aux_minus, t):
        """Ghost (q⁺, aux⁺) on wall face lanes of boundary ``tag``:
        q ``[E, n, X]``, normals ``[E, 3, X]``."""
        bc = self.problem.boundary_conditions[tag - 1]
        return bc.ghost_state(self, nrm, q_minus, aux_minus, t)

    def boundary_state_gradient_flux(self, tag: int, nrm, gf_minus, q_minus,
                                     aux_minus, t):
        """The gradient-flux ghost on wall lanes: the minus side."""
        return gf_minus

    @property
    def has_boundary_flux_second_order(self) -> bool:
        """Walls may prescribe diffusive fluxes (with a turbulence closure
        only)."""
        return self.physics.turbulence is not None

    def boundary_flux_second_order(self, tag: int, nrm, qM, gfM, auxM, t):
        """The normal diffusive flux ``[E, n, X]`` prescribed on the wall
        lanes of boundary ``tag``, or None where the walls prescribe none
        (no closure, or a condition other than ``AtmosBC``): 0 for
        free-slip or no-slip insulating impermeable walls; DragLaw's
        ρ C_d |u_t| u_t on ρu; a moisture flux f_in (prescribed, or the
        bulk formula C_q ρ |u_t| (q_sfc − q)) taken off ρq_tot, ρ and, as
        f_in u, ρu; BulkFormulaEnergy's ρ C_h |u_t| (h − h_sfc) on ρe, or
        a prescribed energy flux taken off it."""
        if self.physics.turbulence is None:
            return None
        bc = self.problem.boundary_conditions[tag - 1]
        if not isinstance(bc, abc.AtmosBC):
            return None
        sp = self.prog_spec
        rho = sp.get(qM, "rho")
        out = torch.zeros_like(qM)
        T, p, u, _ = self.thermo_full(qM, auxM)
        un = torch.sum(u * nrm, dim=1, keepdim=True)
        u_t = u - un * nrm
        speed = torch.linalg.vector_norm(u_t, dim=1)
        mom = bc.momentum
        drag = getattr(mom, "bc", mom)
        if isinstance(drag, abc.DragLaw):
            C_d = _bc_value(drag.C_drag, self, qM, auxM, t, speed)
            out[:, sp.index("rhou")] = (rho * C_d * speed)[:, None] * u_t
        mo = bc.moisture
        if self.physics.moisture.vars_prognostic().num \
                and not isinstance(mo, abc.Impermeable):
            if isinstance(mo, abc.PrescribedMoistureFlux):
                f_in = mo.fn(self, qM, auxM, t) * torch.ones_like(rho)
            else:
                q_sfc = _bc_value(mo.q_tot_sfc, self, qM, auxM, t)
                C_q = _bc_value(mo.C_q, self, qM, auxM, t, speed)
                q_int = sp.get(qM, "moisture.rhoq_tot") / rho
                f_in = C_q * rho * speed * (q_sfc - q_int)
            out[:, sp.index("moisture.rhoq_tot").start] -= f_in
            out[:, sp.index("rho").start] -= f_in
            out[:, sp.index("rhou")] -= f_in[:, None] * u
        en = bc.energy
        i_e = sp.index("rhoe").start
        if isinstance(en, abc.BulkFormulaEnergy):
            ps = self.param_set
            h = (sp.get(qM, "rhoe") + p) / rho
            Phi = self.aux_spec.get(auxM, "orientation.Phi")
            T_sfc = _bc_value(en.T_sfc, self, qM, auxM, t)
            C_h = _bc_value(en.C_h, self, qM, auxM, t, speed)
            h_sfc = td.internal_energy(ps, T_sfc) + ps.R_d * T_sfc + Phi
            out[:, i_e] = rho * C_h * speed * (h - h_sfc)
        elif isinstance(en, abc.PrescribedEnergyFlux):
            f_in = en.fn(self, qM, auxM, t) if callable(en.fn) else en.fn
            out[:, i_e] -= f_in * torch.ones_like(rho)
        return out
