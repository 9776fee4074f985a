"""The atmosphere balance law (port of ``climatemachine_tpu/atmos/model.py``):
``AtmosPhysics`` :76 with every field the JAX package has (``turbulence``
:82, ``tracers`` :84, ``precipitation`` :86, ``viscoussponge`` :87,
``sgstke`` :88, ``energy`` :89 and ``compressibility`` :92 with their
checks :118-138, ``lsforcing`` :94, ``turbconv`` :95 and ``radiation``
:96), the prognostic/aux/gradient schemas :143-233 (the SGS TKE lane
:155-158, EDMF's lanes :159-167, :190-191, :224-228, the gradient lanes
:216-228), ``thermo_full`` :274, ``nodal_init_state_auxiliary`` :334,
``init_state_prognostic`` :354 (EDMF's initial lanes, ρ = ρ_ref under
``Anelastic1D``), the aux refresh through the moisture model and EDMF
(``nodal_update_auxiliary_state`` :493) with radiation's stack
integrals after it :482-490, and the hooks of the generic DG operator:
``flux_first_order`` :372-447 (ρθ advected with no pressure work under
``ThetaModel``; no mass flux and no vertical momentum flux under
``Anelastic1D``; the advected moisture, precipitation, tracer, SGS TKE
and EDMF lanes; radiation's energy flux), ``wavespeed`` :449 (no sound
speed under ``Anelastic1D``), the gradient hooks :502-537, the
gradient-Laplacian hooks :539-550, ``flux_second_order`` :552-580 (the
closure's viscous flux with the moisture's and tracers' diffusion, the
SGS TKE's, hyperdiffusion, EDMF's, then the anelastic projection),
``source`` :583-605, the wall ghost ``boundary_state`` :608-618 (with
EDMF's wall values), the wall fluxes ``boundary_flux_second_order``
:620-694, and the balance law's defaults
``boundary_state_gradient_flux`` and ``update_auxiliary_state_gradient``
(``climatemachine_tpu/balance_laws/interface.py`` :112-115, :133-139).

Prognostic, in the JAX package's order: ρ, ρu(3), ρe (ρθ under
``ThetaModel``), then with ``EquilMoist`` ρq_tot (``NonEquilMoist``:
ρq_tot, ρq_liq, ρq_ice), with a precipitation model ρq_rai (and ρq_sno),
with ``NTracers`` ρχ (N), with ``sgstke`` ρe_SGS, with ``turbconv`` the
EDMF lanes (atmos/edmf.py).  Auxiliary: coord(3), orientation (Φ, ∇Φ),
with a ``HydrostaticState`` the reference state (ρ, p, T, ρe), with a
turbulence closure that needs it ``turbulence.delta``, moisture (θ_v, T
dry; T, θ_v, q_liq, q_ice with ``EquilMoist``; T, θ_v with
``NonEquilMoist``), then, with hyperdiffusion, ``hyperdiffusion.delta``,
with a large-scale forcing its profile, with EDMF the subdomain
temperatures, with radiation its attenuation paths.  With a turbulence
closure the model has gradient lanes (the closure's u, h_tot[, θ_v],
then ``moisture.q_tot``, ``tracers.chi``, ``sgstke.e_SGS``,
``sgstke.theta_li``, ``lsforcing.ta``, ``lsforcing.hus``, EDMF's) and
gradient-flux lanes (the closure's, then ``moisture.d_q_tot``,
``tracers.d_chi``, ``sgstke.d_e_SGS``, ``sgstke.d_theta_li``,
``lsforcing.dz_ta``, ``lsforcing.dz_hus``, EDMF's vertical derivatives).
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
from climatemachine_tpu_torch.atmos.compressibility import Compressible
from climatemachine_tpu_torch.atmos.energy import TotalEnergyModel
from climatemachine_tpu_torch.atmos.moisture import DryModel, EquilMoist
from climatemachine_tpu_torch.atmos.ref_state import (HydrostaticState,
                                                     NoReferenceState,
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
    :mod:`climatemachine_tpu_torch.atmos.radiation`; ``energy`` a
    ``TotalEnergyModel`` (the default) or a ``ThetaModel`` (dry only);
    ``compressibility`` ``Compressible`` (the default) or ``Anelastic1D``
    (with ``TotalEnergyModel`` and a ``HydrostaticState``); ``turbconv``
    None or an :class:`~climatemachine_tpu_torch.atmos.edmf.EDMF` (with a
    closure)."""
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
    energy: object = field(default_factory=TotalEnergyModel)
    compressibility: object = field(default_factory=Compressible)
    lsforcing: Optional[object] = None
    turbconv: Optional[object] = None
    radiation: Optional[object] = None


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


def _remove_vertical(Fm, k):
    """Fm ``[E, 3, 3, L]`` (direction i, momentum component j) less its
    k̂ component in j: Fm_ij − (Σ_j Fm_ij k_j) k_j."""
    return Fm - torch.sum(Fm * k[:, None], dim=2, keepdim=True) * k[:, None]


class AtmosModel(BalanceLaw):
    """Compressible or anelastic atmosphere with total energy or ρθ, dry
    or moist, with passive tracers, precipitation, SGS TKE, EDMF,
    large-scale forcing and radiation (a :class:`BalanceLaw` whose hooks
    override the base's)."""

    def __init__(self, physics: AtmosPhysics, problem: AtmosProblem,
                 sources: Sequence = ()):
        if physics.energy.is_theta and not isinstance(physics.moisture,
                                                      DryModel):
            raise ValueError("ThetaModel energy is dry only")
        if physics.compressibility.is_anelastic:
            if physics.energy.is_theta:
                raise ValueError("Anelastic1D needs TotalEnergyModel")
            if not isinstance(physics.ref_state, HydrostaticState):
                raise ValueError("Anelastic1D needs a hydrostatic reference "
                                 "state")
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
        for name in ("sgstke", "lsforcing", "turbconv"):
            if getattr(physics, name) is not None and turb is None:
                raise ValueError(f"{name} needs a turbulence closure (the "
                                 "gradient pass)")
        if physics.sgstke is not None:
            prog_fields["sgstke"] = physics.sgstke.vars_prognostic()
        tc = physics.turbconv
        if tc is not None:
            prog_fields["turbconv"] = tc.vars_prognostic(self.moist)
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
        for name in ("lsforcing", "turbconv", "radiation"):
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
            if tc is not None:
                gfields["turbconv"] = tc.vars_gradient(self.moist)
                gffields["turbconv"] = tc.vars_gradient_flux(self.moist)
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
        """The problem's initial state, then EDMF's initial lanes, then,
        under ``Anelastic1D``, ρ = ρ_ref."""
        q = self.problem.init_state(self, coords, aux, t)
        if self.physics.turbconv is not None:
            q = self.physics.turbconv.init_state(self, q, aux)
        if self.physics.compressibility.is_anelastic:
            q = _set(q, self.prog_spec.index("rho"),
                     self.aux_spec.get(aux, "ref_state.rho"))
        return q

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
        ``EquilMoist``) and EDMF's subdomain temperatures, then
        radiation's stack integrals."""
        aux = self.physics.moisture.update_aux(self, q, aux)
        if self.physics.turbconv is not None:
            aux = self.physics.turbconv.update_aux(self, q, aux)
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
        precipitation's sedimentation on its lanes, EDMF's vertical
        advection on its lanes, and radiation's energy flux on ρe.
        ``ThetaModel``: F_i[ρθ] = ρθ u_i (no pressure work), the tracers
        advected, nothing else.  ``Anelastic1D``: F[ρ] = 0 and F_i[ρu_j]
        = ρu_i u_j with its k̂ component in j removed (no pressure
        term)."""
        rho, rhou, rhoe = q[:, 0], q[:, 1:4], q[:, 4]
        _, p = self.thermo(q, aux)
        u = rhou / rho[:, None]
        p_eff = p
        if self.ref_state.subtract_off:
            p_eff = p - self.aux_spec.get(aux, "ref_state.p")
        E, n, L = q.shape
        ph = self.physics
        F = torch.empty((E, 3, n, L), dtype=q.dtype, device=q.device)
        F[:, :, 0] = rhou
        F[:, :, 1:4] = rhou[:, :, None] * u[:, None, :]
        if ph.compressibility.is_anelastic:
            F[:, :, 0] = 0.0
            F[:, :, 1:4] = _remove_vertical(F[:, :, 1:4],
                                            self.vertical_unit(aux))
        else:
            for i in range(3):
                F[:, i, 1 + i] += p_eff
        if ph.energy.is_theta:
            F[:, :, 4] = rhoe[:, None] * u
            F[:, :, 5:] = 0.0
            if self.tracers.N:
                sl = self.prog_spec.index("tracers.rhochi")
                F[:, :, sl] = q[:, None, sl] * u[:, :, None]
            return F
        F[:, :, 4] = (rhoe + p)[:, None] * u
        for v in range(5, n):
            F[:, :, v] = q[:, v, None] * u
        if self.precipitation is not None:
            F = self.precipitation.flux_first_order(self, q, aux, F, u)
        if ph.turbconv is not None:
            F = ph.turbconv.flux_first_order(self, q, aux, F)
        rad = self.physics.radiation
        if rad is not None and hasattr(rad, "energy_flux"):
            F[:, :, 4] += rad.energy_flux(self, q, aux)
        return F

    def wavespeed(self, nrm, q, aux, t):
        """|u·n| + the sound speed (none under ``Anelastic1D``), ``[E,
        L]``."""
        T, _, pp = self.physics.moisture.thermo(self, q, aux)
        u = q[:, 1:4] / q[:, :1]
        un = torch.abs(torch.sum(u * nrm, dim=1))
        if self.physics.compressibility.is_anelastic:
            return un
        return un + td.soundspeed_air(self.param_set, T, pp)

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
                                  ph.lsforcing, ph.turbconv)
                if part is not None]

    def compute_gradient_argument(self, q, aux, t):
        """The gradient arguments ``[E, ng, L]``: the closure's (u, h_tot[,
        θ_v]), the moisture's q_tot, the tracers' χ, the SGS TKE's e_SGS
        and θ_li, the large-scale forcing's ta and hus, EDMF's."""
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
        with a hyper state the hyperdiffusive flux; with a gradient flux,
        EDMF's diffusive (and, coupled, its grid-mean) fluxes; under
        ``Anelastic1D`` the k̂ component of F[ρu] removed."""
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
        if self.physics.turbconv is not None and gf is not None:
            F = self.physics.turbconv.flux_second_order(self, q, gf, aux, F)
        if self.physics.compressibility.is_anelastic:
            F[:, :, 1:4] = _remove_vertical(F[:, :, 1:4],
                                            self.vertical_unit(aux))
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
        gradient flux), EDMF's sources (with one), then Σ of the sources
        at (q, aux, ``gf``); under ``Anelastic1D`` the k̂ component of
        the momentum source and any mass source removed."""
        out = torch.zeros_like(q)
        ph = self.physics
        if ph.sgstke is not None:
            out[:, self.prog_spec.index("sgstke.rhoe_SGS").start] += \
                ph.sgstke.source(self, q, gf, aux, t)
        if ph.turbconv is not None and gf is not None:
            out += ph.turbconv.source(self, q, gf, aux, t)
        out = self.sum_sources(self.source_context(q, aux, gf=gf), t, out)
        if ph.compressibility.is_anelastic:
            k = self.vertical_unit(aux)
            Sm = out[:, 1:4]
            out[:, 1:4] = Sm - torch.sum(Sm * k, dim=1, keepdim=True) * k
            out[:, 0] = 0.0
        return out

    def boundary_state(self, tag: int, nrm, q_minus, aux_minus, t):
        """Ghost (q⁺, aux⁺) on wall face lanes of boundary ``tag``:
        q ``[E, n, X]``, normals ``[E, 3, X]``."""
        bc = self.problem.boundary_conditions[tag - 1]
        qP, auxP = bc.ghost_state(self, nrm, q_minus, aux_minus, t)
        if self.physics.turbconv is not None:
            qP = self.physics.turbconv.boundary_state(self, tag, q_minus,
                                                      aux_minus, qP)
        return qP, auxP

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
