"""Dry-Euler volume tendency of the generic DG operator: a hand-written
CUDA kernel for Hopper and its plain PyTorch version (port of
``climatemachine_tpu/dg/pallas_volume.py`` ``dry_volume_tendency`` :101,
body ``_kernel`` :34-94, with ``supports`` :318 and
``volume_tendency_from_grid`` :345).

    out[e, v, :] = MI · Wdiv · concat_a(M · Σ_i ξ[a, i] · (F_i[v] − F_lin,i[v]))

F is the dry Euler flux with e_int, T and p computed from the state and
the geopotential φ (and, with ``subtract_ref``, the reference pressure
taken out of the momentum flux); the linear acoustic(-gravity) flux F_lin of a fused IMEX remainder
is subtracted on the direction slots ``lin_dims``, reading the reference
ρe, ρ and p from ``ref3``.  Unlike ``fused_volume_tendency_vm``
(dg/volume_kernel.py), which the var-major RHS hands its precomputed
pressure, this is the function the generic DG operator calls.

The JAX kernel is node-major; the port keeps state var-major at every
module boundary, so here q is ``[E, 5, Np]`` and so is the tendency.

Dispatch is by device: a CPU tensor takes
:func:`dry_volume_tendency_plain`; any other tensor takes the kernel
(the ``dry_volume_f32`` entry of csrc/volume_vm.cu, which shares the
sum-factorised contraction of ``fused_volume_tendency_vm`` and reads
Wdiv through its line table) or raises.  The kernel covers p1-p5,
float32, with and without ``subtract_ref``, ``lin_dims`` () or, for a
fused remainder in "vertical", "horizontal" or "every", (2,), (0, 1) or
(0, 1, 2), with or without ``lin_gravity``; it refuses a ``lin_dims`` no
direction yields.  The plain version covers the whole JAX signature.
"""

from __future__ import annotations

import torch

from climatemachine_tpu_torch.atmos.linear import (
    AtmosAcousticGravityLinearModel, AtmosAcousticLinearModel)
from climatemachine_tpu_torch.atmos.model import AtmosModel
from climatemachine_tpu_torch.atmos.moisture import DryModel
from climatemachine_tpu_torch.atmos.ref_state import reads_p_ref
from climatemachine_tpu_torch.dg.directions import direction_dims
from climatemachine_tpu_torch.dg.line_ops import wdiv_lines
from climatemachine_tpu_torch.dg.volume_kernel import (KERNEL_LIN_DIMS,
                                                       check_tensors, launch,
                                                       lin_mask,
                                                       volume_tendency_plain)


def dry_volume_tendency_plain(qv, phi, p_ref, ref3, xiv, M, MI, Wdiv,
                              R_d: float, cv_d: float, T_0: float,
                              subtract_ref: bool = True,
                              lin_dims: tuple = (),
                              lin_gravity: bool = True):
    """Plain PyTorch version: the JAX kernel body's thermo, in its order,
    then the flux, metric and contraction of
    :func:`~climatemachine_tpu_torch.dg.volume_kernel.volume_tendency_plain`.
    T = T_0 + e_int · (1/cv_d): a product with the reciprocal, as PyTorch
    computes a tensor divided by a scalar on the card, so the kernel can
    round as this does (the JAX kernel divides; in float64 the two differ
    in the last bit)."""
    rho, ru, rhoe = qv[:, 0], qv[:, 1:4], qv[:, 4]
    inv_rho = 1.0 / rho
    u = ru * inv_rho[:, None]
    e_int = ((rhoe - 0.5 * (ru[:, 0] * u[:, 0] + ru[:, 1] * u[:, 1]
                            + ru[:, 2] * u[:, 2])) * inv_rho - phi)
    T = T_0 + e_int * (1.0 / cv_d)
    p = rho * R_d * T
    return volume_tendency_plain(
        qv, p, phi, p_ref, ref3, None, None, xiv, M, MI, Wdiv, nq=5, ngl=0,
        R_d=R_d, cv_d=cv_d, T_0=T_0, subtract_ref=subtract_ref,
        has_f2=False, lin_dims=lin_dims, lin_gravity=lin_gravity)


def dry_volume_tendency(qv, phi, p_ref, ref3, xiv, M, MI, Wdiv, R_d: float,
                        cv_d: float, T_0: float, subtract_ref: bool = True,
                        lin_dims: tuple = (), lin_gravity: bool = True):
    """Dry volume tendency ``[E, 5, Np]``: qv ``[E, 5, Np]``,
    phi/p_ref/M/MI ``[E, Np]``, ref3 ``[E, 3, Np]`` (reference ρe, ρ, p;
    read only with ``lin_dims``), xiv ``[E, 9, Np]`` (ξ_a,ᵢ at 3a+i), Wdiv
    ``[Np, 3Np]``; p_ref is read only with ``subtract_ref``.

    CPU tensors take the plain version; otherwise the CUDA kernel runs
    and ``dry_volume_tendency.launches`` counts it."""
    if qv.device.type == "cpu":
        return dry_volume_tendency_plain(
            qv, phi, p_ref, ref3, xiv, M, MI, Wdiv, R_d=R_d, cv_d=cv_d,
            T_0=T_0, subtract_ref=subtract_ref, lin_dims=lin_dims,
            lin_gravity=lin_gravity)
    lin_dims = tuple(lin_dims)
    if lin_dims not in KERNEL_LIN_DIMS:
        raise NotImplementedError(
            f"the CUDA dry volume kernel covers lin_dims in "
            f"{KERNEL_LIN_DIMS} (got lin_dims={lin_dims})")
    E, _, Np = qv.shape
    more = {"phi": (phi, (E, Np))}
    if subtract_ref:
        more["p_ref"] = (p_ref, (E, Np))
    if lin_dims:
        more["ref3"] = (ref3, (E, 3, Np))
    check_tensors(qv, xiv, M, MI, Wdiv, **more)
    lines = wdiv_lines(Wdiv)
    out = torch.empty_like(qv)
    launch("dry_volume_f32", qv, qv.data_ptr(), phi.data_ptr(),
           p_ref.data_ptr() if subtract_ref else None,
           ref3.data_ptr() if lin_dims else None,
           xiv.data_ptr(), M.data_ptr(), MI.data_ptr(),
           lines.values.data_ptr(), out.data_ptr(), E, Np,
           lin_mask(lin_dims), int(lin_gravity), int(subtract_ref),
           *lines.strides, R_d, 1.0 / cv_d, T_0, R_d / cv_d)
    dry_volume_tendency.launches += 1
    return out


dry_volume_tendency.launches = 0


def supports(balance_law, grid, direction, remainder=None) -> bool:
    """True when the kernel covers this configuration: the dry,
    total-energy, compressible AtmosModel without radiation in every
    direction, and a
    remainder, if any, of an acoustic(-gravity) linear model."""
    if not isinstance(balance_law, AtmosModel):
        return False
    if remainder is not None:
        lin, ldir = remainder
        if type(lin) not in (AtmosAcousticGravityLinearModel,
                             AtmosAcousticLinearModel):
            return False
        if ldir not in ("vertical", "every", "horizontal"):
            return False
    ph = balance_law.physics
    return (grid.dim == 3 and direction == "every"
            and balance_law.prog_spec.num == 5
            and isinstance(ph.moisture, DryModel) and ph.radiation is None
            and not ph.energy.is_theta
            and not ph.compressibility.is_anelastic
            and grid.Wdiv is not None)


def volume_tendency_from_grid(dg, q, aux, volume=dry_volume_tendency):
    """The kernel's arguments from a DGModel (its grid's metric and
    operators, the model's constants, whether its reference state
    subtracts, the remainder's ``lin_dims``) and the call, through
    ``volume`` (the wrapper, or its plain version); p_ref is None where
    nothing reads it."""
    bl, g = dg.balance_law, dg.grid
    ps, sp = bl.param_set, bl.aux_spec
    phi = sp.get(aux, "orientation.Phi").contiguous()
    subtract = bl.ref_state.subtract_off
    p_ref = (sp.get(aux, "ref_state.p").contiguous() if reads_p_ref(dg)
             else None)
    lin_dims, lin_gravity, ref3 = (), True, None
    if dg.remainder is not None:
        lin, ldir = dg.remainder
        lin_dims = direction_dims(ldir, g.dim)
        lin_gravity = isinstance(lin, AtmosAcousticGravityLinearModel)
        ref3 = torch.stack([sp.get(aux, "ref_state.rhoe"),
                            sp.get(aux, "ref_state.rho"), p_ref], dim=1)
    return volume(q.contiguous(), phi, p_ref, ref3, dg.xiv, g.M, g.MI, g.Wdiv,
                  R_d=ps.R_d, cv_d=ps.cv_d, T_0=ps.T_0,
                  subtract_ref=subtract, lin_dims=lin_dims,
                  lin_gravity=lin_gravity)
