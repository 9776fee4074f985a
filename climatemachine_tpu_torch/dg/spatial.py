"""The generic DG operator (port of ``climatemachine_tpu/dg/spatial.py``:
``contract_flux_metric`` :148, ``weak_divergence_sel`` :124,
``DGModel`` :198 with ``hyperdiffusive_state`` :636, ``pre_stage`` :689
and ``__call__`` :699-864, ``remainder_DGModel`` :867,
init_state_auxiliary :895, init_ode_state :909).

State is var-major ``[E, n, Np]``.  :class:`DGModel` is the right-hand
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
from climatemachine_tpu_torch.dg.numerical_fluxes import RusanovNumericalFlux

VOLUME_KERNELS = ("auto", "pallas", "xla")
SURFACE_KERNELS = ("auto", "varmajor", "xla")
LDG_KERNELS = ("auto", "pallas", "varmajor")


def contract_flux_metric(xi, F):
    """F_ξ ``[E, n, nd, Np]``: ξ_a·F = Σ_i ξ_a,ᵢ F_i for each direction a
    with metric rows ``xi[a]`` ``[E, 3, Np]``, of a flux F ``[E, 3, n,
    Np]``."""
    parts = []
    for xa in xi:
        acc = xa[:, 0, None] * F[:, 0]
        acc = acc + xa[:, 1, None] * F[:, 1]
        acc = acc + xa[:, 2, None] * F[:, 2]
        parts.append(acc)
    return torch.stack(parts, dim=2)


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
    interface term; and ``source``.  ``remainder = (linear model, its
    direction)`` makes this the fused full − linear operator of the
    IMEX step: the linear
    flux, numerical flux and source are subtracted on the linear model's
    slots and faces.

    The JAX package's kernel options:

    - ``volume_kernel``: "auto" and "pallas" take the dry volume kernel
      where :func:`dry_volume_kernel.supports` holds (the AtmosModel), the
      contraction below otherwise; "pallas" on a configuration it does
      not cover raises; "xla" is the plain contraction.
    - ``ldg_kernel``: "auto" and "pallas" run the chain through the four
      chain stages (``chain_stages``: the CUDA kernels), "varmajor" the
      plain per-pass chain (dg/ldg_varmajor.py).
    - ``surface_kernel``: "auto" and "varmajor" take the var-major surface
      pass (dg/fast_surface.py) where :func:`fast_surface.supports` holds
      (the dry AtmosModel in every direction with the Rusanov flux);
      "xla", any other balance law (a moist one among them) and any
      other flux, the generic node-gather pass.

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
    _cache: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    def __post_init__(self):
        bl = self.balance_law
        self.nf1 = (self.numerical_flux_first_order
                    or RusanovNumericalFlux())
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
        self.dry_volume = (
            self.volume_kernel != "xla" and dry_volume_kernel.supports(
                bl, self.grid, self.direction, self.remainder))
        if self.volume_kernel == "pallas" and not self.dry_volume:
            raise ValueError("volume_kernel='pallas': the dry volume kernel "
                             "does not cover this configuration")
        self.fast_surface = (self.surface_kernel != "xla"
                             and fast_surface.supports(self))

    def _cached(self, key, build):
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    def operators(self) -> dict:
        """Static operands on the direction, built at the first call:
        the metric rows ξ_a ``[E, 3, Np]`` per dim, the weak-divergence
        columns, the face node ids, normals, weights, lift and wall
        tags of the direction's faces, and the neighbour tables."""
        def build():
            g = self.grid
            E, Np, Nfp = g.nelem, g.Np, g.Nfp_max
            dims = direction_dims(self.direction, g.dim)
            faces = direction_faces(self.direction, g.dim)
            cols = np.concatenate([np.arange(f * Nfp, (f + 1) * Nfp)
                                   for f in faces])
            idx = lambda a: torch.as_tensor(a, dtype=torch.int64,
                                            device=g.device)
            bctag = g.face_bctag[:, list(faces)]
            return dict(
                faces=faces,
                xi=[g.xi_x[:, :, a, :].transpose(1, 2) for a in dims],
                WT=torch.cat([g.Wdiv[:, a * Np:(a + 1) * Np] for a in dims],
                             dim=1).T.contiguous(),
                node=idx(g.fmask_padded[list(faces)].reshape(-1)),
                nrm=g.normals[:, list(faces)].permute(0, 3, 1, 2).reshape(
                    E, 3, -1),
                sM=g.sM[:, list(faces)].reshape(E, 1, -1),
                liftT=g.lift[:, idx(cols)].T.contiguous(),
                bctag=bctag.repeat_interleave(Nfp, dim=1),
                tags=sorted(int(x) for x in bctag.unique() if x != 0),
                tab=fast_surface._tables(g))
        return self._cached("ops", build)

    @property
    def xiv(self):
        """ξ ``[E, 9, Np]`` (ξ_a,ᵢ at 3a + i), the dry kernel's metric."""
        g = self.grid
        return self._cached("xiv", lambda: g.xi_x.permute(0, 2, 3, 1).reshape(
            g.nelem, 9, g.Np).contiguous())

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

    def __call__(self, q, aux, t):
        bl, g = self.balance_law, self.grid
        if not hasattr(bl, "flux_first_order"):
            raise NotImplementedError(
                "next slice: a balance law without a first-order flux")
        if q.device.type == "cuda":
            require_full_fp32("the DG operator")
        ops = self.operators()
        if self.update_aux:
            aux = bl.update_auxiliary_state(q, aux)

        # volume: M⁻¹ Σ_a D_aᵀ (M ξ_a·F) over the direction's dims; the dry
        # kernel covers the first-order part (the remainder's linear flux
        # included), F₂ rides the contraction on top
        F2 = None
        if bl.gradlap_spec.num:
            hyper = self.hyperdiffusive_state(q, aux, t)
            F2 = bl.flux_second_order(q, None, hyper, aux, t)
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

        tend = tend + self.surface(q, aux, t)
        if F2 is not None:
            tend = tend + ldg_varmajor.scalar_hyper_correction(
                self, F2, self.direction)

        tend = tend + bl.source(q, aux, t)
        if self.remainder is not None:
            tend = tend - self.remainder[0].source(q, aux, t)
        return tend, aux

    def surface(self, q, aux, t):
        """The interface term − M⁻¹ L (sM · f*) over the direction's
        faces: the var-major surface pass (``fast_surface``) or the
        node-gather pass."""
        if self.fast_surface:
            return fast_surface.surface_tendency(self, q, aux, t)
        return self._generic_surface(q, aux, t)

    def _generic_surface(self, q, aux, t):
        """− M⁻¹ L (sM · f*) by node gathers: the face bundle (q, aux) at
        the direction's face nodes, its neighbour side, the balance law's
        wall ghost and numerical flux, less the remainder's on its
        faces."""
        bl, g, ops = self.balance_law, self.grid, self.operators()
        n, Nfp = q.shape[1], g.Nfp_max
        BM = torch.cat([q, aux], dim=1)[:, :, ops["node"]]
        BP = fast_surface.gather_faces(ops["tab"], BM, ops["faces"], Nfp)
        qM, auxM, qP, auxP = BM[:, :n], BM[:, n:], BP[:, :n], BP[:, n:]
        nrm = ops["nrm"]
        for tag in ops["tags"]:
            qB, auxB = bl.boundary_state(tag, nrm, qM, auxM, t)
            mask = (ops["bctag"] == tag)[:, None, :]
            qP = torch.where(mask, qB, qP)
            auxP = torch.where(mask, auxB, auxP)
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
    coords = grid.coords.transpose(1, 2)                 # [E, 3, Np]
    aux = torch.zeros((grid.nelem, balance_law.aux_spec.num, grid.Np),
                      dtype=grid.dtype, device=grid.device)
    aux[:, balance_law.aux_spec.index("coord")] = coords
    return balance_law.nodal_init_state_auxiliary(coords, aux, grid)


def init_ode_state(dg: DGModel, t0: float = 0.0):
    """Var-major (q0, aux0) from the balance law's initial condition."""
    bl, grid = dg.balance_law, dg.grid
    aux = init_state_auxiliary(bl, grid)
    q = bl.init_state_prognostic(grid.coords.transpose(1, 2), aux, t0)
    return q, bl.update_auxiliary_state(q, aux)
