"""Carry grids and state over from numpy arrays, so one geometry and one
state can be fed to this package and to another implementation of it.

``grid_from_numpy`` takes the arrays of a node-major grid (the
``climatemachine_tpu`` ``Grid`` fields, as numpy), 3-D or 2-D.  The JAX package's
"grid" layout is node-major ``[E, Np, n]``; this package keeps state,
aux and tendencies var-major ``[E, n, Np]``: ``to_var_major`` and
``to_node_major`` turn one into the other, ``state_from_numpy`` and
``state_to_numpy`` a (state, aux) pair: the dry model's 5 prognostic
lanes, the moist model's 6 (ρq_tot after ρe) or, with precipitation and
tracers, more (ρq_tot, ρq_rai, ρχ…), the ocean's 4 (u[0], u[1], η,
θ; aux coord, y, w, pkin, wz0, ud, dGu), the shallow-water model's 3
(η, U[0], U[1]; aux coord (2), y, GU, du) and the barotropic model's
(the same, its aux also U_c, η_c, U_s, η_s, η_diag, Δη), the forced
LES models' (NonEquilMoist's ρq_tot, ρq_liq, ρq_ice; the SGS TKE's
ρe_SGS; the aux lanes of radiation's attenuation paths and of the
large-scale forcing's profile), and their aux lanes, in the lane order
the two packages share.  Given the other package's lane names,
``state_from_numpy`` checks them against the model's schema name by
name.
"""

from __future__ import annotations

import numpy as np
import torch

from climatemachine_tpu_torch.device import resolve_device
from climatemachine_tpu_torch.mesh.grid import Grid

#: grid fields uploaded in the run dtype
FLOAT_FIELDS = ("coords", "M", "MI", "J", "JcV", "xi_x", "normals", "sM",
                "lift", "Wdiv", "Wgrad")
#: grid fields uploaded as int64
INDEX_FIELDS = ("face_bctag", "face_nbr_row")
#: grid fields kept on the host
HOST_FIELDS = ("dim", "xi", "face_perm_identity", "fmask_padded", "n_horz",
               "n_vert")


def grid_from_numpy(fields: dict, device=None,
                    dtype: torch.dtype = torch.float32) -> Grid:
    """A :class:`Grid` from a dict holding the arrays named in
    ``FLOAT_FIELDS`` and ``INDEX_FIELDS`` and the host fields
    ``HOST_FIELDS``: ``dim`` (3 or 2; the count of 1-D node arrays where
    absent), the 1-D node tuple ``xi``, ``face_perm_identity``,
    ``fmask_padded`` and the stack's ``n_horz`` and ``n_vert`` (None for
    a grid that is not stacked)."""
    device = resolve_device(device)
    up = {k: torch.tensor(np.asarray(fields[k]), dtype=dtype, device=device)
          for k in FLOAT_FIELDS}
    up.update({k: torch.tensor(np.asarray(fields[k]), dtype=torch.int64,
                               device=device) for k in INDEX_FIELDS})
    xi = tuple(np.asarray(x, dtype=np.float64) for x in fields["xi"])
    Nq = tuple(len(x) for x in xi)
    dim = int(fields.get("dim", len(Nq)))
    if dim != len(Nq) or dim not in (2, 3):
        raise ValueError(f"a {dim}-D grid with {len(Nq)} node arrays")
    # face f's nodes: the product of the other dims' node counts
    Nfp = tuple(int(np.prod([Nq[t] for t in range(dim) if t != f // 2]))
                for f in range(2 * dim))
    return Grid(Nq=Nq, Np=int(np.prod(Nq)), Nfp=Nfp, dim=dim,
                Nfp_max=max(Nfp), xi=xi,
                face_perm_identity=bool(fields["face_perm_identity"]),
                fmask_padded=np.array(fields["fmask_padded"], dtype=np.int64),
                n_horz=fields["n_horz"], n_vert=fields["n_vert"], **up)


def grid_to_numpy(grid) -> dict:
    """The fields :func:`grid_from_numpy` takes, as numpy arrays, from a
    grid of either package."""
    host = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a))
    out = {k: host(getattr(grid, k)) for k in FLOAT_FIELDS + INDEX_FIELDS}
    out.update({k: getattr(grid, k) for k in HOST_FIELDS})
    return out


def to_var_major(a, device=None, dtype=None) -> torch.Tensor:
    """A node-major ``[E, Np, n]`` array → a var-major ``[E, n, Np]``
    contiguous tensor; ``dtype=None`` keeps the array's dtype."""
    return torch.tensor(np.asarray(a), dtype=dtype,
                        device=resolve_device(device)).transpose(
                            1, 2).contiguous()


def to_node_major(t) -> np.ndarray:
    """A var-major ``[E, n, Np]`` tensor → a node-major ``[E, Np, n]``
    numpy array."""
    return np.ascontiguousarray(t.detach().cpu().numpy().transpose(0, 2, 1))


def _check_lanes(model, nq: int, naux: int, names=None):
    """Raise ValueError unless ``model`` (if given) has nq prognostic and
    naux aux lanes and, with ``names`` = (prognostic names, aux names),
    those flattened lane names in that order."""
    if model is None:
        return
    if (nq, naux) != (model.prog_spec.num, model.aux_spec.num):
        raise ValueError(
            f"state with {nq} prognostic and {naux} aux lanes, the model "
            f"has {model.prog_spec.num} and {model.aux_spec.num}")
    if names is None:
        return
    for kind, got, spec in (("prognostic", names[0], model.prog_spec),
                            ("aux", names[1], model.aux_spec)):
        want = list(spec.flattened_names())
        if list(got) != want:
            raise ValueError(f"{kind} lanes {list(got)}, the model has "
                             f"{want}")


def state_from_numpy(q, aux, device=None, dtype=None, model=None,
                     names=None):
    """Node-major ``[E, Np, n]`` q and aux → var-major ``[E, n, Np]``
    contiguous tensors; ``dtype=None`` keeps the arrays' dtype.  With
    ``model``, the lane counts must be its prognostic and aux specs' and,
    with ``names`` (the flattened lane names of the arrays' prognostic
    and aux schemas), the names too."""
    _check_lanes(model, np.shape(q)[-1], np.shape(aux)[-1], names)
    return (to_var_major(q, device, dtype), to_var_major(aux, device, dtype))


def state_to_numpy(q, aux, model=None):
    """Var-major q and aux → node-major ``[E, Np, n]`` numpy arrays; with
    ``model``, the lane counts checked as :func:`state_from_numpy` checks
    them."""
    _check_lanes(model, q.shape[1], aux.shape[1])
    return to_node_major(q), to_node_major(aux)
