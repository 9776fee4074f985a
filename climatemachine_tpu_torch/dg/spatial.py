"""The (balance law, grid) holder with the generic first-order DG
operator, the direction helpers and state initialization (port of
``climatemachine_tpu/dg/spatial.py``: direction_dims/direction_faces
:46-58, the first-order part of ``DGModel.__call__`` :699-864,
init_state_auxiliary :895, init_ode_state :909).

State is var-major ``[E, n, Np]``.  The full AtmosModel runs through the
var-major RHS (dg/fast_rhs.py); :meth:`DGModel.__call__` serves balance
laws with a first-order flux only, such as the linear acoustic models
of the IMEX step (atmos/linear.py).  The JAX package has no Pallas
kernel on this operator: it is plain torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from climatemachine_tpu_torch.dg import fast_surface
from climatemachine_tpu_torch.dg.numerical_fluxes import RusanovNumericalFlux

_RUSANOV = RusanovNumericalFlux()
_DIMS = {"every": lambda dim: tuple(range(dim)),
         "horizontal": lambda dim: tuple(range(dim - 1)),
         "vertical": lambda dim: (dim - 1,)}


def direction_dims(direction: str, dim: int) -> Tuple[int, ...]:
    """Reference directions a derivative in ``direction`` ("every",
    "horizontal" or "vertical") acts along."""
    if direction not in _DIMS:
        raise ValueError(direction)
    return _DIMS[direction](dim)


def direction_faces(direction: str, dim: int) -> Tuple[int, ...]:
    """Faces normal to the reference directions of ``direction``."""
    return tuple(f for d in direction_dims(direction, dim)
                 for f in (2 * d, 2 * d + 1))


@dataclass
class DGModel:
    """A balance law on a grid, discretized in ``direction``.

    Calling it gives ``(dq/dt, aux')`` for a balance law with a first-
    order flux and no gradient or hyperdiffusive state: the weak volume
    divergence of ``flux_first_order`` along the direction's reference
    dims, the Rusanov numerical flux on the direction's faces with the
    balance law's ``boundary_state`` as the wall ghost, lifted, and
    ``source``.  ``update_aux`` runs the balance law's
    ``update_auxiliary_state`` first.  ``remainder`` (a linear model
    subtracted for IMEX) belongs to a later slice; the var-major RHS and
    this operator refuse it."""
    balance_law: object
    grid: object
    remainder: Optional[tuple] = None
    direction: str = "every"
    update_aux: bool = True
    _ops: Optional[dict] = field(default=None, init=False, repr=False,
                                 compare=False)

    def _operators(self) -> dict:
        """Static operands on the direction, built at the first call:
        the metric rows ξ_a ``[E, 3, Np]`` per dim, the weak-divergence
        columns, the face node ids, normals, weights, lift and wall
        tags of the direction's faces, and the neighbour tables."""
        if self._ops is None:
            g = self.grid
            E, Np, Nfp = g.nelem, g.Np, g.Nfp_max
            dims = direction_dims(self.direction, g.dim)
            faces = direction_faces(self.direction, g.dim)
            cols = np.concatenate([np.arange(f * Nfp, (f + 1) * Nfp)
                                   for f in faces])
            idx = lambda a: torch.as_tensor(a, dtype=torch.int64,
                                            device=g.device)
            bctag = g.face_bctag[:, list(faces)]
            self._ops = dict(
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
        return self._ops

    def __call__(self, q, aux, t):
        bl, g = self.balance_law, self.grid
        if (self.remainder is not None
                or not hasattr(bl, "flux_first_order")
                or bl.gradlap_spec.num > 0):
            raise NotImplementedError(
                "next slice: the generic DG operator covers first-order "
                "balance laws without gradient or hyperdiffusive state and "
                "without a remainder; the full AtmosModel runs through "
                "VarMajorRHS")
        ops = self._operators()
        if self.update_aux:
            aux = bl.update_auxiliary_state(q, aux)
        E, n, Np = q.shape

        # volume: M⁻¹ Σ_a D_aᵀ (M ξ_a·F) over the direction's dims
        F = bl.flux_first_order(q, aux, t)               # [E, 3, n, Np]
        parts = []
        for xa in ops["xi"]:
            acc = xa[:, 0, None] * F[:, 0]
            acc = acc + xa[:, 1, None] * F[:, 1]
            acc = acc + xa[:, 2, None] * F[:, 2]
            parts.append(g.M[:, None] * acc)
        mf = torch.stack(parts, dim=2).reshape(E * n, -1)
        tend = g.MI[:, None] * torch.matmul(mf, ops["WT"]).reshape(E, n, Np)

        # interface: − M⁻¹ L (sM · f*) over the direction's faces
        BM = torch.cat([q, aux], dim=1)[:, :, ops["node"]]
        BP = fast_surface.gather_faces(ops["tab"], BM, ops["faces"],
                                       g.Nfp_max)
        qM, auxM, qP, auxP = BM[:, :n], BM[:, n:], BP[:, :n], BP[:, n:]
        nrm = ops["nrm"]
        for tag in ops["tags"]:
            qB, auxB = bl.boundary_state(tag, nrm, qM, auxM, t)
            mask = (ops["bctag"] == tag)[:, None, :]
            qP = torch.where(mask, qB, qP)
            auxP = torch.where(mask, auxB, auxP)
        fstar = _RUSANOV(bl, nrm, qM, auxM, qP, auxP, t)
        lifted = torch.matmul((ops["sM"] * fstar).reshape(E * n, -1),
                              ops["liftT"]).reshape(E, n, Np)
        tend = tend - g.MI[:, None] * lifted
        return tend + bl.source(q, aux, t), aux


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
