"""Var-major RHS of the Held-Suarez step, the moist baroclinic wave and
the isentropic vortex (port of ``climatemachine_tpu/dg/fast_rhs.py``
``VarMajorRHS`` :141-682 for a dry model, with or without DryBiharmonic
hyperdiffusion, and an EquilMoist model with EquilMoistBiharmonic; with
the Rusanov flux; either full or as a fused remainder
``remainder_DGModel(dg, dg_lin)`` of an acoustic(-gravity) linear model
in "vertical" or "every", :97-105; ``supports`` :52, which refuses
a turbulence closure, tracers, precipitation and the microphysics
sources, :76-85).

State and aux stay var-major ``[E, nvar, Np]`` throughout.  Per call:

- thermo once: T, p and the sound speed, reused by the volume flux, the
  face fluxes (faces are nodal subsets, so face thermo is extracted, not
  recomputed) and the sources; with EquilMoist, T by the saturation
  adjustment and the four moisture aux lanes written on every call;
- with hyperdiffusion, the LDG chain ∇→Δ→∇ of (u_h, h_tot[, q_tot])
  through the four chain kernels (dg/ldg_kernel.py); ν₄ = (Δ/2)⁴/2τ and
  ν₄_q = (Δ/2)⁴/2τ_q (0 when dry) are built once;
- volume: the fused volume-tendency kernel (dg/volume_kernel.py), which
  builds the hyperdiffusive flux F₂ from ∇Δ and ν₄ itself;
- the reference pressure p_ref: taken out of the momentum flux where the
  reference state's ``subtract_off`` says so (a HydrostaticState by
  default), not read at all on a NoReferenceState (the isentropic
  vortex), read for a remainder's linear flux without being taken out
  on a HydrostaticState that does not subtract (:380, :412, :640-670);
- surface: the face bundle (q, p, c, p_ref where read and, with
  hyperdiffusion, the n·F₂ trace built on the faces from the extracted
  ∇Δ), neighbour rows by gathers over elements, wall ghosts, Rusanov
  flux plus the interior hyperdiffusive correction, and the lift.
  ``surface_kernel`` picks how, with the JAX package's names: ``"xla"`` (the default) is
  plain PyTorch, one extraction matmul against the 0/1 lift matrix and
  one lift matmul; ``"hybrid"`` builds the bundle with the extraction
  kernel (dg/surface_kernel.py); ``"pallas"`` also runs the flux and
  lift kernel after the gather;
- sources: the model's ``contributions_vm`` hooks.

A fused remainder (the full RHS less the linear model's, in one pass)
takes the linear flux out in the volume kernel on the linear direction's
derivative slots (``lin_dims``), carries three more aux lanes on the face
bundle (φ, the linear energy coefficient and the reference sound speed,
after p_ref: na = 4) and takes the linear Rusanov flux out on the linear
direction's faces, and, for the acoustic-gravity model, adds back the
gravity source ρ∇Φ the linear model holds.
"""

from __future__ import annotations

from typing import Callable

import torch

from climatemachine_tpu_torch.atmos.hyperdiffusion import (
    DryBiharmonic, EquilMoistBiharmonic)
from climatemachine_tpu_torch.atmos.linear import (
    AtmosAcousticGravityLinearModel, AtmosAcousticLinearModel)
from climatemachine_tpu_torch.atmos.model import AtmosModel
from climatemachine_tpu_torch.atmos.moisture import DryModel, EquilMoist
from climatemachine_tpu_torch.atmos.ref_state import reads_p_ref
from climatemachine_tpu_torch.dg import (fast_surface, ldg_kernel,
                                        surface_kernel)
from climatemachine_tpu_torch.dg.directions import (direction_dims,
                                                    direction_faces)
from climatemachine_tpu_torch.dg.numerical_fluxes import RusanovNumericalFlux
from climatemachine_tpu_torch.dg.volume_kernel import fused_volume_tendency_vm
from climatemachine_tpu_torch.physics import thermodynamics as td


#: the surface passes, by the JAX package's names (module docstring)
SURFACE_KERNELS = ("xla", "hybrid", "pallas")


def _unsupported(dg):
    """(exception type, reason) why VarMajorRHS does not take ``dg``, or
    None when it does."""
    bl, g = dg.balance_law, dg.grid
    if not isinstance(bl, AtmosModel):
        return ValueError, "VarMajorRHS needs an AtmosModel"
    if dg.direction != "every":
        return ValueError, ("VarMajorRHS discretizes in every direction, "
                            f"got {dg.direction!r}")
    if type(getattr(dg, "nf1", None)) is not RusanovNumericalFlux:
        return ValueError, ("VarMajorRHS computes the Rusanov flux, got "
                            f"{getattr(dg, 'nf1', None)!r}")
    ph = bl.physics
    for what, refused in (("ThetaModel energy", ph.energy.is_theta),
                          ("Anelastic1D", ph.compressibility.is_anelastic),
                          ("turbconv (EDMF)", ph.turbconv is not None)):
        if refused:
            # the JAX package's supports refuses these too (fast_rhs.py:78)
            return ValueError, (f"VarMajorRHS takes no {what}: the generic "
                                "DG operator does")
    if bl.physics.turbulence is not None:
        # the JAX package's supports refuses a closure too (fast_rhs.py:78):
        # this RHS has no gradient pass, so taking the model here would
        # drop its viscous flux without a word
        return ValueError, ("VarMajorRHS has no gradient pass: a "
                            "turbulence closure takes the generic DG "
                            "operator")
    if not isinstance(ph.moisture, (DryModel, EquilMoist)):
        return ValueError, ("VarMajorRHS takes a dry or an EquilMoist "
                            f"model, got {ph.moisture!r}")
    for name in ("sgstke", "radiation", "lsforcing"):
        if getattr(ph, name) is not None:
            return ValueError, (f"VarMajorRHS takes no {name}: the "
                                "generic DG operator does")
    hd = ph.hyperdiffusion
    if not (hd is None or type(hd) in (DryBiharmonic, EquilMoistBiharmonic)):
        return NotImplementedError, "next slice"
    if dg.remainder is not None:
        lin, ldir = dg.remainder
        if type(lin) not in (AtmosAcousticGravityLinearModel,
                             AtmosAcousticLinearModel):
            return ValueError, ("VarMajorRHS takes the remainder of an "
                                "acoustic(-gravity) linear model, got "
                                f"{lin!r}")
        if ldir not in ("vertical", "every") \
                or not bl.has_ref_state:
            return ValueError, ("VarMajorRHS takes a remainder in "
                                "'vertical' or 'every' about a reference "
                                f"state, got {ldir!r}")
    if hd is not None and bl.moist != (type(hd) is EquilMoistBiharmonic):
        return ValueError, ("VarMajorRHS takes EquilMoist with "
                            "EquilMoistBiharmonic and a dry model with "
                            f"DryBiharmonic, got {hd!r}")
    if not g.face_perm_identity:
        return ValueError, "VarMajorRHS needs identity face orientations"
    for bc in bl.problem.boundary_conditions:
        if not bc.is_free_slip_wall():
            return ValueError, ("VarMajorRHS implements the impenetrable "
                                "free-slip, insulating wall only")
    if bl.tracers.N or bl.precipitation is not None:
        return ValueError, ("VarMajorRHS takes no tracers and no "
                            "precipitation: the generic DG operator does")
    for src in bl.sources:
        if not (hasattr(src, "contributions_vm")
                and getattr(src, "on_var_major_rhs", True)):
            return ValueError, (f"source {src!r} runs on the generic DG "
                                "operator only")
    return None


def supports(dg) -> bool:
    """True when VarMajorRHS takes ``dg``'s configuration (the JAX
    package's ``fast_rhs.supports``, :52-131, for what the port has)."""
    return _unsupported(dg) is None


def _check_supported(dg):
    why = _unsupported(dg)
    if why is not None:
        raise why[0](why[1])


class VarMajorRHS:
    """``(qv, auxv, t) -> (dqv, auxv')`` with qv ``[E, 5, Np]`` and auxv
    ``[E, 13, Np]`` on a hydrostatic reference state (``[E, 14, Np]``
    with hyperdiffusion; ``[E, 9, Np]`` without a reference state); with
    EquilMoist qv ``[E, 6, Np]`` and auxv ``[E, 15, Np]`` (16).  ``dg``
    is the full model's DGModel or a fused remainder (module docstring).

    ``write_aux``: refresh the dry aux lanes θ_v and T from the state on
    every call.  Nothing inside a step reads them, so a time integrator
    can build the RHS with ``write_aux=False`` and call
    :meth:`export_aux` when aux leaves the loop.  A moist model writes
    its four moisture lanes on every call whatever ``write_aux`` says,
    as the JAX package does.  ``volume`` is the volume-tendency function,
    ``chain_stages`` the four chain stages and ``surface_stages`` the
    extraction and the flux + lift of the ``"hybrid"`` and ``"pallas"``
    surface passes; they default to the kernel wrappers, and chip_smoke.py
    passes the plain versions to hold one step against the kernels'.

    ``surface_kernel`` (attribute, ``"xla"`` by default): the surface
    pass, one of :data:`SURFACE_KERNELS` (module docstring)."""

    def __init__(self, dg, write_aux: bool = True,
                 volume: Callable = fused_volume_tendency_vm,
                 chain_stages: tuple = ldg_kernel.KERNELS,
                 surface_stages: tuple = surface_kernel.KERNELS):
        _check_supported(dg)
        self.bl, self.grid = dg.balance_law, dg.grid
        self.write_aux = write_aux
        self.volume = volume
        self.chain_stages = chain_stages
        self.surface_stages = surface_stages
        self.surface_kernel = "xla"
        g, bl = self.grid, self.bl
        E, X = g.nelem, g.nface * g.Nfp_max
        sp = bl.aux_spec
        self.nq = bl.prog_spec.num
        self.moist = bl.moist
        self.i_phi = sp.index("orientation.Phi").start
        self.rem = dg.remainder
        # the reference pressure: taken out of the momentum flux where
        # the reference state subtracts it, a bundle lane where that or a
        # remainder needs it, and not read at all otherwise
        self.subtract = bl.ref_state.subtract_off
        self.i_pref = (sp.index("ref_state.p").start if reads_p_ref(dg)
                       else None)
        if self.rem is not None:
            lin, ldir = self.rem
            self.lin_gravity = isinstance(lin, AtmosAcousticGravityLinearModel)
            self.lin_dims = direction_dims(ldir, g.dim)
            faces = direction_faces(ldir, g.dim)
            self.lin_lanes = (faces[0] * g.Nfp_max,
                              (faces[-1] + 1) * g.Nfp_max)
            self.i_gphi = sp.index("orientation.grad_Phi")
        # var-major geometry, built once
        self.xiv = g.xi_x.permute(0, 2, 3, 1).reshape(E, 9, g.Np).contiguous()
        self.nrm = g.normals.permute(0, 3, 1, 2).reshape(E, 3, X).contiguous()
        self.sM = g.sM.reshape(E, 1, X)
        self.liftT = g.lift.T.contiguous()
        self.tab = fast_surface._tables(g)
        self.bmask = self.tab["bnd_lane"][:, None, :].to(g.M.dtype)
        self.hd = bl.physics.hyperdiffusion
        if self.hd is not None:
            d = bl.hyperdiffusion_direction
            self.chain = ldg_kernel.chain_operators(
                g, direction_dims(d, g.dim), direction_faces(d, g.dim))
            # ν₄ = (Δ/2)⁴ / 2τ and ν₄_q = (Δ/2)⁴ / 2τ_q are static (Δ,
            # the aux lane hyperdiffusion.delta, depends on the grid
            # alone): the kernels' (ν₄, ν₄_q) [E, 2, Np], ν₄_q = 0 when
            # dry, and each on the faces [E, X]
            delta4 = (self.hd.lengthscale(g) / 2) ** 4
            nu4 = delta4 / (2 * self.hd.tau_timescale)
            nu4q = (delta4 / (2 * self.hd.tau_timescale_q_tot)
                    if self.moist else torch.zeros_like(nu4))
            self.nu = torch.stack([nu4, nu4q], dim=1)
            self.nu4_faces = torch.matmul(nu4, g.lift)
            self.nu4q_faces = torch.matmul(nu4q, g.lift)

    def _thermo_update(self, qv, auxv, write_aux: bool):
        """T, p, c_s and, with ``write_aux`` or a moist model, a copy of
        aux with the moisture lanes refreshed (θ_v and T dry; T from the
        saturation adjustment, θ_v, q_liq and q_ice with EquilMoist)."""
        ps, sp = self.bl.param_set, self.bl.aux_spec
        rho, ru, rhoe = qv[:, 0], qv[:, 1:4], qv[:, 4]
        Phi = auxv[:, self.i_phi]
        e_int = (rhoe - 0.5 * torch.sum(ru * ru, dim=1) / rho) / rho - Phi
        if self.moist:
            q_tot = qv[:, 5] / rho
            T = td.saturation_adjustment(
                ps, e_int, rho, q_tot,
                n_iter=self.bl.physics.moisture.maxiter)
            pp = td.phase_partition_equil(ps, T, rho, q_tot)
            p = td.air_pressure(ps, T, rho, pp)
            theta_v = td.virtual_temperature(ps, T, pp) * \
                (ps.MSLP / p) ** ps.kappa_d
            auxv = auxv.clone()
            for name, val in (("moisture.temperature", T),
                              ("moisture.theta_v", theta_v),
                              ("moisture.q_liq", pp.liq),
                              ("moisture.q_ice", pp.ice)):
                auxv[:, sp.index(name).start] = val
            return T, p, td.soundspeed_air(ps, T, pp), auxv
        T = td.air_temperature(ps, e_int)
        p = td.air_pressure(ps, T, rho)
        c_s = td.soundspeed_air(ps, T)
        if write_aux:
            auxv = auxv.clone()
            auxv[:, sp.index("moisture.air_T").start] = T
            auxv[:, sp.index("moisture.theta_v").start] = \
                T * (ps.MSLP / p) ** ps.kappa_d
        return T, p, c_s, auxv

    def export_aux(self, qv, auxv):
        """Aux with the moisture lanes brought up to date with ``qv``."""
        return self._thermo_update(qv, auxv, write_aux=True)[3]

    # --- hyperdiffusion chain -------------------------------------------------
    def chain_input(self, qv, auxv, p):
        """(u_h, h_tot) ``[E, 4, Np]``: the horizontal velocity and the
        total specific enthalpy (ρe + p)/ρ; with EquilMoist also q_tot
        (``[E, 5, Np]``)."""
        return self.hd.gradient_laplacian_argument(self.bl, qv, auxv, 0.0, p)

    def _chain(self, qv, auxv, p):
        """gl2 ``[E, 3·n, Np]``: ∇Δ of the n chain variables at lane
        n·i + j (direction i, variable j).  The hyperdiffusive flux itself is
        never stored: the volume kernel and the surface pass build it
        from gl2 and ν₄."""
        glv = self.chain_input(qv, auxv, p)
        gl2 = ldg_kernel.chain_vm(glv, self.chain, self.chain_stages)
        E, n, Np = glv.shape
        return gl2.reshape(E, 3 * n, Np)

    # --- surface -------------------------------------------------------------
    def _gather_faces(self, Bf):
        """Neighbour side of the face bundle ``[E, nvb, X]``."""
        return fast_surface.gather_faces(self.tab, Bf,
                                         tuple(range(self.grid.nface)),
                                         self.grid.Nfp_max)

    def _aux_lanes(self, auxv):
        """The bundle's aux lanes ``[E, na, Np]``: none where nothing reads
        p_ref (na = 0), else p_ref (na = 1); with a remainder also φ, the
        linear energy coefficient (ρe_ref + p_ref)/ρ_ref (less φ for the
        acoustic model) and the reference sound speed (na = 4)."""
        if self.i_pref is None:
            return auxv[:, :0]
        if self.rem is None:
            return auxv[:, self.i_pref:self.i_pref + 1].contiguous()
        sp, ps = self.bl.aux_spec, self.bl.param_set
        p_ref = auxv[:, self.i_pref]
        phi = auxv[:, self.i_phi]
        coeff = (sp.get(auxv, "ref_state.rhoe") + p_ref) \
            / sp.get(auxv, "ref_state.rho")
        if not self.lin_gravity:
            coeff = coeff - phi
        return torch.stack([p_ref, phi, coeff, td.soundspeed_air(
            ps, sp.get(auxv, "ref_state.T"))], dim=1)

    def _bundle(self, qv, p, c_s, aux_lanes, gl2):
        """Minus-side face bundle ``[E, nvb, X]``: lanes q (nq), p, c_s,
        the aux lanes, and with ``gl2`` the nq n·F₂ trace lanes, built on
        the faces from ∇Δ extracted by the same matmul and the static face
        ν₄, ν₄_q (each side contracts its own volume F₂ with its own
        normal)."""
        g, nq, nrm = self.grid, self.nq, self.nrm
        E, Np = g.nelem, g.Np
        X = g.nface * g.Nfp_max
        lanes = [qv, p[:, None], c_s[:, None], aux_lanes]
        if gl2 is not None:
            lanes.append(gl2)
        B = torch.cat(lanes, dim=1)
        Bx = torch.matmul(B.reshape(-1, Np), g.lift).reshape(E, -1, X)
        if gl2 is None:
            return Bx
        nvb = nq + 2 + aux_lanes.shape[1]
        ngl = gl2.shape[1] // 3
        gl2f = Bx[:, nvb:].reshape(E, 3, ngl, X)
        nu4f, nu4qf = self.nu4_faces, self.nu4q_faces
        G = torch.sum(nrm[:, :, None, :] * gl2f, dim=1)   # [E, ngl, X]
        rhoF = Bx[:, 0]
        rnu = rhoF * nu4f
        trace = ([torch.zeros_like(rhoF)] + [rnu * G[:, j] for j in range(3)]
                 + [nu4f * (Bx[:, 1] * G[:, 0] + Bx[:, 2] * G[:, 1]
                            + Bx[:, 3] * G[:, 2]) + rnu * G[:, 3]])
        if nq > 5:
            trace.append(rhoF * nu4qf * G[:, 4])
        return torch.cat([Bx[:, :nvb], torch.stack(trace, dim=1)], dim=1)

    def _extract(self, qv, p, c_s, aux_lanes, gl2):
        """The face bundle of :meth:`_bundle` from the extraction stage."""
        hyper = gl2 is not None
        return self.surface_stages[0](
            qv, p, c_s, aux_lanes, gl2, self.nu if hyper else None,
            self.grid.lift, self.nrm, nq=self.nq, na=aux_lanes.shape[1],
            ngl=self.bl.gradlap_spec.num, has_hyper=hyper)

    def _flux_lift(self, Bf, BP, hyper: bool):
        """The surface term from the bundle and its neighbour side by the
        flux + lift stage."""
        ps, nq = self.bl.param_set, self.nq
        rem_lanes, (sl_lo, sl_hi) = (
            ((nq + 3, nq + 4, nq + 5), self.lin_lanes) if self.rem
            else ((), (0, 0)))
        return self.surface_stages[1](
            Bf, BP, self.nrm, self.sM, self.bmask, self.liftT, self.grid.MI,
            nq=nq, nvb=Bf.shape[1], subtract=self.subtract,
            i_pref=nq if self.i_pref is None else nq + 2,
            has_hyper=hyper, rem_lanes=rem_lanes, sl_lo=sl_lo, sl_hi=sl_hi,
            R_d_T0=ps.R_d * ps.T_0, R_over_cv=ps.R_d / ps.cv_d)

    def _surface(self, qv, p, c_s, aux_lanes, gl2=None):
        """Rusanov surface term −M⁻¹ L (sM · f*), ``[E, nq, Np]``, of the
        state, its thermo and the aux lanes (:meth:`_aux_lanes`); with
        ``gl2`` the interior hyperdiffusive correction ½(s⁻ − s⁺) of the
        n·F₂ traces joins f* (wall faces carry none); a remainder takes
        the linear model's Rusanov flux out on its faces."""
        mode = self.surface_kernel
        if mode not in SURFACE_KERNELS:
            raise ValueError(f"surface_kernel must be one of "
                             f"{SURFACE_KERNELS}, got {mode!r}")
        g, nq, nrm = self.grid, self.nq, self.nrm
        if mode == "xla":
            Bf = self._bundle(qv, p, c_s, aux_lanes, gl2)
        else:
            Bf = self._extract(qv, p, c_s, aux_lanes, gl2)
        BP = self._gather_faces(Bf)
        if mode == "pallas":
            return self._flux_lift(Bf, BP, gl2 is not None)

        BP = fast_surface.wall_ghost(BP, nrm, self.tab["bnd_lane"])
        fstar = fast_surface.rusanov(Bf, BP, nrm, nq, self.subtract)
        if gl2 is not None:
            base = nq + 2 + aux_lanes.shape[1]
            sl_h = slice(base, base + nq)
            fstar = fstar + torch.where(
                self.tab["bnd_lane"][:, None, :], 0.0,
                0.5 * (Bf[:, sl_h] - BP[:, sl_h]))
        if self.rem is not None:
            sl = slice(*self.lin_lanes)
            fstar[:, :, sl] -= fast_surface.linear_rusanov(
                Bf[:, :, sl], BP[:, :, sl], nrm[:, :, sl], nq, nq + 3,
                self.bl.param_set)
        return fast_surface.lift(fstar, self.sM, self.liftT, g.MI)

    # --- sources -------------------------------------------------------------
    def _sources(self, qv, auxv, T, p, t):
        return self.bl.sum_sources(self.bl.source_context(qv, auxv, (T, p)),
                                   t)

    # --- full RHS ------------------------------------------------------------
    def __call__(self, qv, auxv, t):
        g, ps, sp = self.grid, self.bl.param_set, self.bl.aux_spec
        T, p, c_s, auxv = self._thermo_update(qv, auxv, self.write_aux)
        hyper = self.hd is not None
        gl2 = self._chain(qv, auxv, p) if hyper else None
        aux_lanes = self._aux_lanes(auxv)
        p_ref = (aux_lanes[:, 0].contiguous()    # a view when na = 1
                 if self.i_pref is not None else None)
        phi, ref3, lin_dims, lin_gravity = auxv[:, self.i_phi], None, (), True
        if self.rem is not None:
            phi = phi.contiguous()
            ref3 = torch.stack([sp.get(auxv, "ref_state.rhoe"),
                                sp.get(auxv, "ref_state.rho"), p_ref], dim=1)
            lin_dims, lin_gravity = self.lin_dims, self.lin_gravity
        tend = self.volume(qv, p, phi, p_ref, ref3, gl2,
                           self.nu if hyper else None, self.xiv, g.M, g.MI,
                           g.Wdiv, nq=self.nq, ngl=self.bl.gradlap_spec.num,
                           R_d=ps.R_d, cv_d=ps.cv_d, T_0=ps.T_0,
                           subtract_ref=self.subtract, has_f2=hyper,
                           lin_dims=lin_dims,
                           lin_gravity=lin_gravity)
        tend = tend + self._surface(qv, p, c_s, aux_lanes, gl2)
        tend = tend + self._sources(qv, auxv, T, p, t)
        if self.rem is not None and self.lin_gravity:
            # take out the linear model's gravity source −ρ∇Φ
            tend[:, 1:4] += qv[:, :1] * auxv[:, self.i_gphi]
        return tend, auxv
