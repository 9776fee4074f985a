"""The generic DG operator (port of ``climatemachine_tpu/dg/spatial.py``:
``contract_flux_metric`` :148, ``weak_divergence_sel`` :124,
``ref_gradient`` :162, ``strong_gradient`` :183, ``DGModel`` :198 with
its gradient fluxes and ``diffusion_direction`` :232-235, ``n_gradient``
:302, ``spatial_gradient`` :429-456, ``hyperdiffusive_state`` :636,
``dg_gradient_of`` :560-583, ``pre_stage`` :689 and ``__call__``
:699-864, ``remainder_DGModel`` :867, init_state_auxiliary :895,
init_ode_state :909).  The balance
law's hooks are those of ``balance_laws/interface.py``; the ocean's
(``pre_stage`` → ``preprocess_state``, the stack integrals in
``update_auxiliary_state_gradient``) need no branch here.

State is var-major ``[E, n, Np]``; fluxes and gradients carry one row
per coordinate direction, ``grid.dim`` of them (3, or 2 on the
barotropic ocean's 2-D grid).  :class:`DGModel` is the right-hand
side of a balance law on a grid: of the full AtmosModel (the JAX
package's node-major "grid" layout; here state stays var-major, and
interop.py transposes the JAX package's tensors), dry or moist, with
tracers and precipitation, of the linear acoustic models of the IMEX
step in the vertical direction, and of the fused IMEX remainder (full −
linear).  Its kernels are the dry volume kernel (dg/dry_volume_kernel.py;
the dry model only) and the hyperdiffusion chain (dg/ldg_kernel.py; n =
4 rows dry, 5 with EquilMoistBiharmonic); everything else is plain
PyTorch, as the JAX package leaves it to XLA: on a moist model the
saturation adjustment of ``update_aux``, the volume flux of every lane
and the node-gather surface pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np
import torch

from climatemachine_tpu_torch.atmos.hyperdiffusion import (
    DryBiharmonic, EquilMoistBiharmonic)
from climatemachine_tpu_torch.device import require_full_fp32
from climatemachine_tpu_torch.dg import (dry_volume_kernel, fast_surface,
                                        ldg_tables, ldg_varmajor)
from climatemachine_tpu_torch.dg.directions import (direction_dims,
                                                    direction_faces)
from climatemachine_tpu_torch.dg.ldg_kernel import (KERNELS as CHAIN_KERNELS,
                                                    ChainOperators,
                                                    chain_operators)
from climatemachine_tpu_torch.dg.numerical_fluxes import (
    CentralNumericalFluxGradient, CentralNumericalFluxSecondOrder,
    RusanovNumericalFlux)

VOLUME_KERNELS = ("auto", "pallas", "xla")
SURFACE_KERNELS = ("auto", "varmajor", "xla")
LDG_KERNELS = ("auto", "pallas", "varmajor")


def contract_flux_metric(xi, F):
    """F_ξ ``[E, n, nd, Np]``: ξ_a·F = Σ_i ξ_a,ᵢ F_i for each direction a
    with metric rows ``xi[a]`` ``[E, d, Np]``, of a flux F ``[E, d, n,
    Np]``, summed in direction order."""
    parts = []
    for xa in xi:
        acc = xa[:, 0, None] * F[:, 0]
        for i in range(1, F.shape[1]):
            acc = acc + xa[:, i, None] * F[:, i]
        parts.append(acc)
    return torch.stack(parts, dim=2)


def ref_gradient(grid, g, dims):
    """D_a g ``[E, ng, len(dims), Np]`` of g ``[E, ng, Np]`` along the
    reference dims ``dims``: one matmul against the matching rows of
    Wgrad, the variable axis folded into the rows."""
    E, ng, Np = g.shape
    W = torch.cat([grid.Wgrad[a * Np:(a + 1) * Np] for a in dims], dim=0)
    return torch.matmul(g.reshape(E * ng, Np), W.T).reshape(
        E, ng, len(dims), Np)


def strong_gradient(grid, g, dims):
    """The nodal gradient ∂g/∂x_i = Σ_a ξ_a,ᵢ D_a g ``[E, d, ng, Np]`` of
    g ``[E, ng, Np]`` (direction i, then variable), over the reference
    dims ``dims``."""
    dg = ref_gradient(grid, g, dims)
    out = 0.0
    for k, a in enumerate(dims):
        xa = grid.xi_x[:, :, a, :].transpose(1, 2)          # [E, d, Np]
        out = out + xa[:, :, None, :] * dg[:, None, :, k, :]
    return out


def weak_divergence_sel(grid, F_xi, WT):
    """Σ_a D_aᵀ (M F_ξa) ``[E, n, Np]`` over the directions of F_ξ
    ``[E, n, nd, Np]``, with WT the matching columns of Wdiv transposed
    ``[nd·Np, Np]``: one matmul with the variable axis folded into the
    rows."""
    E, n = F_xi.shape[:2]
    mf = (grid.M[:, None, None] * F_xi).reshape(E * n, -1)
    return torch.matmul(mf, WT).reshape(E, n, grid.Np)


@dataclass
class DGModel:
    """A balance law on a grid, discretized in ``direction``.

    Calling it gives ``(dq/dt, aux')``: with ``update_aux`` the balance
    law's ``update_auxiliary_state`` first; then, for a balance law with
    gradient-Laplacian state (DryBiharmonic hyperdiffusion), the hyper
    state and its second-order flux F₂; the weak volume divergence of the
    first-order flux (and F₂) along the direction's reference dims; the
    numerical flux ``numerical_flux_first_order`` (``nf1``: Rusanov by
    default, or Roe or HLLC) on the direction's faces with the balance
    law's ``boundary_state`` as the wall ghost, lifted, and F₂'s
    interface term; and ``source``.  A balance law with gradient lanes
    (``n_gradient`` > 0: a turbulence closure) first gets its gradient
    along ``diffusion_direction`` (:meth:`spatial_gradient`), its
    gradient flux and ``update_auxiliary_state_gradient``; F₂ then holds
    the viscous flux, its face term is ``numerical_flux_second_order``
    (``nf2``, central) with the gradient flux's wall ghost
    ``boundary_state_gradient_flux`` and the walls' prescribed fluxes
    ``boundary_flux_second_order``.  ``remainder = (linear model, its
    direction)`` makes this the fused full − linear operator of the
    IMEX step: the linear
    flux, numerical flux and source are subtracted on the linear model's
    slots and faces.

    The JAX package's kernel options:

    - ``volume_kernel``: "auto" and "pallas" take the dry volume kernel
      where :func:`dry_volume_kernel.supports` holds (the AtmosModel) and
      the model has no gradient lanes (with a gradient flux the JAX
      package's kernel is not taken either), the contraction below
      otherwise; "pallas" on a configuration it does
      not cover raises; "xla" is the plain contraction.
    - ``ldg_kernel``: "auto" and "pallas" run the chain through the four
      chain stages (``chain_stages``: the CUDA kernels), "varmajor" the
      plain per-pass chain (dg/ldg_varmajor.py).
    - ``surface_kernel``: "auto" and "varmajor" take the var-major surface
      pass (dg/fast_surface.py) where :func:`fast_surface.supports` holds
      (the dry AtmosModel in every direction with the Rusanov flux);
      "xla", any other balance law (a moist one, one with gradient lanes
      among them) and any other flux, the generic node-gather pass.

    ``volume`` is the dry volume function (the kernel wrapper; chip_smoke.py
    passes its plain version)."""
    balance_law: object
    grid: object
    remainder: Optional[tuple] = None
    direction: str = "every"
    update_aux: bool = True
    volume_kernel: str = "auto"
    surface_kernel: str = "auto"
    ldg_kernel: str = "auto"
    volume: Callable = dry_volume_kernel.dry_volume_tendency
    chain_stages: tuple = CHAIN_KERNELS
    numerical_flux_first_order: Optional[object] = None
    numerical_flux_gradient: Optional[object] = None
    numerical_flux_second_order: Optional[object] = None
    diffusion_direction: Optional[str] = None
    _cache: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    def __post_init__(self):
        bl = self.balance_law
        self.nf1 = (self.numerical_flux_first_order
                    or RusanovNumericalFlux())
        self.nfg = (self.numerical_flux_gradient
                    or CentralNumericalFluxGradient())
        self.nf2 = (self.numerical_flux_second_order
                    or CentralNumericalFluxSecondOrder())
        self.diffusion_direction = self.diffusion_direction or self.direction
        for name, allowed in (("volume_kernel", VOLUME_KERNELS),
                              ("surface_kernel", SURFACE_KERNELS),
                              ("ldg_kernel", LDG_KERNELS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got "
                                 f"{getattr(self, name)!r}")
        hd = getattr(getattr(bl, "physics", None), "hyperdiffusion", None)
        if hd is not None and type(hd) not in (DryBiharmonic,
                                               EquilMoistBiharmonic):
            raise NotImplementedError(f"next slice: hyperdiffusion {hd!r}")
        supported = dry_volume_kernel.supports(bl, self.grid, self.direction,
                                               self.remainder)
        if self.volume_kernel == "pallas" and not supported:
            raise ValueError("volume_kernel='pallas': the dry volume kernel "
                             "does not cover this configuration")
        # with a gradient flux neither the dry kernel nor the var-major
        # surface pass (both first-order only) is taken, as in JAX
        # (spatial.py:721, :774)
        self.dry_volume = (self.volume_kernel != "xla" and supported
                           and self.n_gradient == 0)
        self.fast_surface = (self.surface_kernel != "xla"
                             and self.n_gradient == 0
                             and fast_surface.supports(self))

    @property
    def n_gradient(self) -> int:
        """The balance law's number of gradient lanes (0 without a
        turbulence closure)."""
        spec = getattr(self.balance_law, "grad_spec", None)
        return spec.num if spec is not None else 0

    def _cached(self, key, build):
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    def face_operators(self, direction) -> dict:
        """Static face operands of ``direction``'s faces, built at the
        first call: the face ids, their node ids, normals, weights, lift
        and wall tags, the tags present and the neighbour tables."""
        def build():
            g = self.grid
            E, Nfp = g.nelem, g.Nfp_max
            faces = direction_faces(direction, g.dim)
            cols = np.concatenate([np.arange(f * Nfp, (f + 1) * Nfp)
                                   for f in faces])
            idx = lambda a: torch.as_tensor(a, dtype=torch.int64,
                                            device=g.device)
            bctag = g.face_bctag[:, list(faces)]
            return dict(
                faces=faces,
                node=idx(g.fmask_padded[list(faces)].reshape(-1)),
                nrm=g.normals[:, list(faces)].permute(0, 3, 1, 2).reshape(
                    E, g.dim, -1),
                sM=g.sM[:, list(faces)].reshape(E, 1, -1),
                liftT=g.lift[:, idx(cols)].T.contiguous(),
                bctag=bctag.repeat_interleave(Nfp, dim=1),
                tags=sorted(int(x) for x in bctag.unique() if x != 0),
                tab=fast_surface._tables(g))
        return self._cached(("faces", direction), build)

    def operators(self) -> dict:
        """Static operands on the direction, built at the first call:
        :meth:`face_operators` of its faces, the metric rows ξ_a ``[E, d,
        Np]`` per dim and the weak-divergence columns."""
        def build():
            g = self.grid
            Np = g.Np
            dims = direction_dims(self.direction, g.dim)
            return dict(
                self.face_operators(self.direction),
                xi=[g.xi_x[:, :, a, :].transpose(1, 2) for a in dims],
                WT=torch.cat([g.Wdiv[:, a * Np:(a + 1) * Np] for a in dims],
                             dim=1).T.contiguous())
        return self._cached("ops", build)

    @property
    def xiv(self):
        """ξ ``[E, d², Np]`` (ξ_a,ᵢ at d·a + i), the dry kernel's
        metric."""
        g = self.grid
        return self._cached("xiv", lambda: g.xi_x.permute(0, 2, 3, 1).reshape(
            g.nelem, g.dim ** 2, g.Np).contiguous())

    def ldg_operators(self, direction) -> ChainOperators:
        """The chain's tables and geometry on ``direction``'s dims and
        faces."""
        g = self.grid
        return self._cached(("ldg", direction), lambda: chain_operators(
            g, direction_dims(direction, g.dim),
            direction_faces(direction, g.dim)))

    def ldg_geometry(self, direction):
        """The per-pass chain's geometry (sM, normals, ξ, MI) on
        ``direction``."""
        g = self.grid
        return self._cached(("geom", direction), lambda: ldg_tables.geom(
            g, direction_faces(direction, g.dim),
            direction_dims(direction, g.dim)))

    def hyperdiffusive_state(self, q, aux, t):
        """ν₄∇Δ of the gradient-Laplacian argument ``[E, 3, n, Np]``, along
        the balance law's hyperdiffusion direction."""
        direction = (getattr(self.balance_law, "hyperdiffusion_direction",
                             None) or self.direction)
        return ldg_varmajor.hyper_chain(self, q, aux, t, direction)

    def pre_stage(self, q, aux, t):
        """The balance law's state projection before each RHS evaluation
        (``pre_stage=dg.pre_stage`` of the time integrators)."""
        return self.balance_law.preprocess_state(self, q, aux, t)

    def face_state(self, ops, q, aux, t):
        """(qM, auxM, qP, auxP) ``[E, n, X]`` on the faces of ``ops``: the
        own side, and the neighbour's or, on wall lanes, the balance
        law's ghost state."""
        n = q.shape[1]
        BM, BP = self._face_sides(ops, torch.cat([q, aux], dim=1))
        qM, auxM = BM[:, :n], BM[:, n:]
        return (qM, auxM) + self._wall_ghost(ops, qM, auxM, BP[:, :n],
                                             BP[:, n:], t)

    def spatial_gradient(self, q, aux, t, faces=None):
        """The DG gradient ``[E, d, ng, Np]`` of the balance law's gradient
        arguments along ``diffusion_direction``: the strong gradient
        within each element plus the lift of sM · n ⊗ (g* − g⁻) on the
        direction's faces, the central g* from the neighbour side or, on
        wall lanes, from the ghost state ``boundary_state`` of the wall's
        tag; ``faces`` is that direction's :meth:`face_state` where the
        caller has it."""
        bl, g = self.balance_law, self.grid
        ops = self.face_operators(self.diffusion_direction)
        grad = strong_gradient(g, bl.compute_gradient_argument(q, aux, t),
                               direction_dims(self.diffusion_direction,
                                              g.dim))
        qM, auxM, qP, auxP = faces or self.face_state(ops, q, aux, t)
        corr = self.nfg(bl, ops["nrm"], bl.compute_gradient_argument(
            qM, auxM, t), bl.compute_gradient_argument(qP, auxP, t))
        return grad + self._lift_jump(ops, corr)

    def _lift_jump(self, ops, corr):
        """M⁻¹ L (sM · corr) ``[E, d, n, Np]`` of a face jump correction
        ``[E, d, n, X]`` on the faces of ``ops``: the strong form ADDS the
        lifted jump, and fast_surface.lift returns the weak form's −M⁻¹ L
        (sM f), hence the minus."""
        E, d, n, X = corr.shape
        return -fast_surface.lift(corr.reshape(E, d * n, X), ops["sM"],
                                  ops["liftT"], self.grid.MI).reshape(
                                      E, d, n, self.grid.Np)

    def dg_gradient_of(self, x, direction: Optional[str] = None):
        """The central-flux DG gradient ``[E, d, n, Np]`` of arbitrary
        fields x ``[E, n, Np]`` along ``direction`` (default
        ``diffusion_direction``): the strong gradient plus the lifted
        sM · n ⊗ (½(x⁺ + x⁻) − x⁻), x⁺ the neighbour's (the own face at a
        wall, where the jump is 0)."""
        g = self.grid
        direction = direction or self.diffusion_direction
        ops = self.face_operators(direction)
        xM, xP = self._face_sides(ops, x)
        corr = ops["nrm"][:, :, None, :] * (0.5 * (xP + xM) - xM)[:, None]
        return (strong_gradient(g, x, direction_dims(direction, g.dim))
                + self._lift_jump(ops, corr))

    def __call__(self, q, aux, t):
        bl = self.balance_law
        if not hasattr(bl, "flux_first_order"):
            raise NotImplementedError(
                "next slice: a balance law without a first-order flux")
        if q.device.type == "cuda" and q.dtype == torch.float32:
            require_full_fp32("the DG operator")
        if self.update_aux:
            aux = bl.update_auxiliary_state(q, aux, self.grid)

        gf = faces = None
        if self.n_gradient:
            faces = self.face_state(self.face_operators(
                self.diffusion_direction), q, aux, t)
            gf = bl.compute_gradient_flux(
                self.spatial_gradient(q, aux, t, faces), q, aux, t)
            aux_g, q_g = bl.update_auxiliary_state_gradient(self, gf, q, aux,
                                                            t)
            # the face state serves the surface pass too where it has the
            # same faces and the state and aux are unchanged
            if (aux_g is not aux or q_g is not q
                    or self.diffusion_direction != self.direction):
                faces = None
            aux, q = aux_g, q_g
        hyper = (self.hyperdiffusive_state(q, aux, t)
                 if bl.gradlap_spec.num else None)

        tend, F2 = self.volume_tendency(q, aux, t, gf, hyper)

        # a hyper-only F₂ (no gradient flux, walls prescribing no diffusive
        # flux) takes the scalar n·F₂ exchange on interior faces; otherwise
        # the hyper state rides the face bundle
        scalar_hyper = (hyper is not None and gf is None and not getattr(
            bl, "has_boundary_flux_second_order",
            hasattr(bl, "boundary_flux_second_order")))
        tend = tend + self.surface(q, aux, t, gf,
                                   None if scalar_hyper else hyper, faces)
        if scalar_hyper:
            tend = tend + ldg_varmajor.scalar_hyper_correction(
                self, F2, self.direction)

        tend = tend + (bl.source(q, aux, t) if gf is None
                       else bl.source(q, aux, t, gf=gf))
        if self.remainder is not None:
            tend = tend - self.remainder[0].source(q, aux, t)
        return tend, aux

    def volume_tendency(self, q, aux, t, gf=None, hyper=None):
        """(M⁻¹ Σ_a D_aᵀ (M ξ_a·F) over the direction's dims ``[E, n, Np]``,
        F₂ or None): F the first-order flux, less a remainder's linear
        flux on its dims, plus F₂, the second-order flux of the gradient
        flux ``gf`` and the hyper state ``hyper`` where either is given.
        The dry kernel, where taken, covers the first-order part (the
        remainder's linear flux included) and F₂ rides the contraction
        on top."""
        bl, g, ops = self.balance_law, self.grid, self.operators()
        F2 = (bl.flux_second_order(q, gf, hyper, aux, t)
              if gf is not None or hyper is not None else None)
        tend = None
        if self.dry_volume:
            tend = dry_volume_kernel.volume_tendency_from_grid(
                self, q, aux, self.volume)
            F = F2
        else:
            F = bl.flux_first_order(q, aux, t)
            if F2 is not None:
                F = F + F2
        if F is not None:
            F_xi = contract_flux_metric(ops["xi"], F)
            if self.remainder is not None and not self.dry_volume:
                lin, ldir = self.remainder
                dims = direction_dims(self.direction, g.dim)
                ldims = direction_dims(ldir, g.dim)
                F_lin = contract_flux_metric(
                    [ops["xi"][dims.index(a)] for a in ldims],
                    lin.flux_first_order(q, aux, t))
                for i, a in enumerate(ldims):
                    F_xi[:, :, dims.index(a)] -= F_lin[:, :, i]
            wd = g.MI[:, None] * weak_divergence_sel(g, F_xi, ops["WT"])
            tend = wd if tend is None else tend + wd
        return tend, F2

    def surface(self, q, aux, t, gf=None, hyper=None, faces=None):
        """The interface term − M⁻¹ L (sM · f*) over the direction's
        faces: the var-major surface pass (``fast_surface``; first order
        only) or the node-gather pass, which adds the second-order flux
        F₂* of the gradient flux ``gf`` and the hyper state ``hyper``
        where given (``faces``: the direction's :meth:`face_state`, where
        the caller has it)."""
        if self.fast_surface and gf is None and hyper is None:
            return fast_surface.surface_tendency(self, q, aux, t)
        return self._generic_surface(q, aux, t, gf, hyper, faces)

    def _face_sides(self, ops, B):
        """(minus, neighbour) sides ``[E, nv, X]`` of the volume bundle B
        ``[E, nv, Np]`` at the face nodes of ``ops`` (a wall's neighbour
        is its own face)."""
        BM = B[:, :, ops["node"]]
        return BM, fast_surface.gather_faces(ops["tab"], BM, ops["faces"],
                                             self.grid.Nfp_max)

    def _wall_ghost(self, ops, qM, auxM, qP, auxP, t):
        """(qP, auxP) with the balance law's ghost state on the wall lanes
        of each boundary tag."""
        for tag in ops["tags"]:
            qB, auxB = self.balance_law.boundary_state(tag, ops["nrm"], qM,
                                                       auxM, t)
            mask = (ops["bctag"] == tag)[:, None, :]
            qP = torch.where(mask, qB, qP)
            auxP = torch.where(mask, auxB, auxP)
        return qP, auxP

    def _generic_surface(self, q, aux, t, gf=None, hyper=None, faces=None):
        """− M⁻¹ L (sM · f*) by node gathers: the face bundle (q, aux, and
        gf and the hyper state where given) at the direction's face
        nodes, its neighbour side, the balance law's wall ghost and
        numerical flux, less the remainder's on its faces; with gf or
        hyper, plus the second-order flux F₂* (``nf2``) with the gradient
        flux's wall ghost, no hyperdiffusive transport through walls, and
        the walls' prescribed diffusive fluxes in place of F₂* there."""
        bl, g, ops = self.balance_law, self.grid, self.operators()
        Nfp = g.Nfp_max
        parts = [] if faces is not None else [q, aux]
        if gf is not None:
            parts.append(gf)
        if hyper is not None:
            parts.append(hyper.reshape(g.nelem, -1, g.Np))
        if parts:
            BM, BP = self._face_sides(ops, torch.cat(parts, dim=1))
        if faces is None:
            n, naux = q.shape[1], aux.shape[1]
            qM, auxM = BM[:, :n], BM[:, n:n + naux]
            qP, auxP = self._wall_ghost(ops, qM, auxM, BP[:, :n],
                                        BP[:, n:n + naux], t)
            off = n + naux
        else:
            qM, auxM, qP, auxP = faces
            off = 0
        nrm = ops["nrm"]
        fstar = self.nf1(bl, nrm, qM, auxM, qP, auxP, t)
        if self.remainder is not None:
            lin, ldir = self.remainder
            pos = [ops["faces"].index(f)
                   for f in direction_faces(ldir, g.dim)]
            if pos != list(range(pos[0], pos[0] + len(pos))):
                raise ValueError("the linear faces must be contiguous in "
                                 "the active face set")
            sl = slice(pos[0] * Nfp, (pos[-1] + 1) * Nfp)
            fstar[:, :, sl] -= self.nf1(lin, nrm[:, :, sl], qM[:, :, sl],
                                        auxM[:, :, sl], qP[:, :, sl],
                                        auxP[:, :, sl], t)
        if gf is not None or hyper is not None:
            walls = [(tag, (ops["bctag"] == tag)[:, None, :])
                     for tag in ops["tags"]]
            gfM = gfP = hyM = hyP = None
            if gf is not None:
                ngf = gf.shape[1]
                gfM, gfP = BM[:, off:off + ngf], BP[:, off:off + ngf]
                off += ngf
                for tag, mask in walls:
                    gfP = torch.where(mask, bl.boundary_state_gradient_flux(
                        tag, nrm, gfM, qM, auxM, t), gfP)
            if hyper is not None:
                # no hyperdiffusive transport through walls
                interior = (ops["bctag"] == 0)[:, None, :]
                shape = (g.nelem,) + hyper.shape[1:3] + (-1,)
                hyM = torch.where(interior, BM[:, off:], 0.0).reshape(shape)
                hyP = torch.where(interior, BP[:, off:], 0.0).reshape(shape)
            f2star = self.nf2(bl, nrm, qM, gfM, auxM, qP, gfP, auxP, t, hyM,
                              hyP)
            if hasattr(bl, "boundary_flux_second_order"):
                for tag, mask in walls:
                    fb = bl.boundary_flux_second_order(tag, nrm, qM, gfM,
                                                       auxM, t)
                    if fb is not None:
                        f2star = torch.where(mask, fb, f2star)
            fstar = fstar + f2star
        return fast_surface.lift(fstar, ops["sM"], ops["liftT"], g.MI)


def remainder_DGModel(dg_full: DGModel, dg_lin: DGModel) -> DGModel:
    """The fused full − linear operator: ``dg_full`` with the remainder
    ``(dg_lin.balance_law, dg_lin.direction)``, its options (the numerical
    flux among them) kept; equal to the two-call difference ``dg_full(q)
    − dg_lin(q)``, in one volume and one face pass."""
    return replace(dg_full,
                   remainder=(dg_lin.balance_law, dg_lin.direction))


def init_state_auxiliary(balance_law, grid):
    """Aux ``[E, naux, Np]`` with the coordinates filled, then the
    model's nodal initialization (which reads the grid's metrics)."""
    coords = grid.coords.transpose(1, 2)                 # [E, d, Np]
    aux = torch.zeros((grid.nelem, balance_law.aux_spec.num, grid.Np),
                      dtype=grid.dtype, device=grid.device)
    aux[:, balance_law.aux_spec.index("coord")] = coords
    return balance_law.nodal_init_state_auxiliary(coords, aux, grid)


def init_ode_state(dg: DGModel, t0: float = 0.0,
                   init_state: Optional[Callable] = None):
    """Var-major (q0, aux0) from the balance law's initial condition or,
    given, ``init_state(balance_law, coords [E, d, Np], aux, t0)`` in its
    place (the split-explicit ocean's 2-D state at rest, or a problem's
    ``sw_init_state``)."""
    bl, grid = dg.balance_law, dg.grid
    aux = init_state_auxiliary(bl, grid)
    coords = grid.coords.transpose(1, 2)
    q = (bl.init_state_prognostic(coords, aux, t0) if init_state is None
         else init_state(bl, coords, aux, t0))
    return q, bl.update_auxiliary_state(q, aux, grid)
