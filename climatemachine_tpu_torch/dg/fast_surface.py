"""Var-major surface pass of the Euler model (port of
``climatemachine_tpu/dg/fast_surface.py``: ``supports`` :38-96,
``_tables`` :99-132 and ``surface_tendency`` :135-263, with its
fused-remainder subtraction).

Face data is var-major ``[E, nvb, nface·Nfp]``.  The neighbour side of
face f is, for most elements, the opposite face ``f ^ 1`` of the
neighbour element: one row gather over elements of a contiguous lane
slice.  Panel-edge elements whose neighbour presents another face get
small row fix-ups.  Orientations must be identity (checked by the
callers).

The pass is shared: :func:`surface_tendency` is the generic DG
operator's (dg/spatial.py; face thermo from the extracted state and φ,
as the JAX package computes it), and the var-major RHS's plain pass
(dg/fast_rhs.py, surface pass "xla") extracts its own thermo lanes; both
then take the wall ghost, the Rusanov flux, a remainder's linear Rusanov
flux and the lift from here.  The
JAX package runs this pass in XLA, not in a Pallas kernel: it is plain
PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from climatemachine_tpu_torch.atmos.linear import \
    AtmosAcousticGravityLinearModel
from climatemachine_tpu_torch.atmos.model import AtmosModel
from climatemachine_tpu_torch.atmos.moisture import DryModel
from climatemachine_tpu_torch.atmos.ref_state import reads_p_ref
from climatemachine_tpu_torch.dg.directions import direction_faces
from climatemachine_tpu_torch.dg.numerical_fluxes import RusanovNumericalFlux
from climatemachine_tpu_torch.physics import thermodynamics as td


def supports(dg) -> bool:
    """True when the generic DG operator ``dg`` takes this pass: the dry
    AtmosModel (five prognostic lanes, DryModel, total energy,
    compressible, no EDMF, no tracers, no radiation: the JAX package's
    conditions) with the Rusanov flux in
    every direction on a grid of identity face orientations, with
    impenetrable free-slip,
    insulating walls.  Any other configuration, a moist one among them,
    takes the node-gather pass (``DGModel._generic_surface``)."""
    bl, g = dg.balance_law, dg.grid
    return (isinstance(bl, AtmosModel) and dg.direction == "every"
            and g.face_perm_identity and bl.prog_spec.num == 5
            and isinstance(bl.physics.moisture, DryModel)
            and not bl.physics.energy.is_theta
            and not bl.physics.compressibility.is_anelastic
            and bl.physics.turbconv is None
            and bl.physics.radiation is None
            and bl.tracers.N == 0
            and type(dg.nf1) is RusanovNumericalFlux
            and all(bc.is_free_slip_wall()
                    for bc in bl.problem.boundary_conditions))


def _tables(grid):
    """{"nbr_e": [E] per face, "fix": [(src_face, rows, src_elems)] per
    face, "opp": face ^ 1, "bnd_lane": [E, nface·Nfp] wall mask}, as
    int64/bool tensors on the grid's device."""
    nface, dev = grid.nface, grid.device
    nbr_row = grid.face_nbr_row.cpu().numpy()
    nbr_e, nbr_f = nbr_row // nface, nbr_row % nface
    opp = np.arange(nface) ^ 1
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
    tab = {"nbr_e": [], "fix": [], "opp": opp}
    for f in range(nface):
        tab["nbr_e"].append(idx(nbr_e[:, f]))
        fixes = []
        bad = nbr_f[:, f] != opp[f]
        for fsrc in np.unique(nbr_f[bad, f]):
            rows = np.where(bad & (nbr_f[:, f] == fsrc))[0]
            fixes.append((int(fsrc), idx(rows), idx(nbr_e[rows, f])))
        tab["fix"].append(fixes)
    bnd = grid.face_bctag.cpu().numpy() != 0
    tab["bnd_lane"] = torch.as_tensor(np.repeat(bnd, grid.Nfp_max, axis=1),
                                      device=dev)
    return tab


def gather_faces(tab, Bf, faces, Nfp: int):
    """Neighbour side of a minus-side face bundle ``[E, nvb, len(faces)·
    Nfp]`` that holds ``faces`` in that order.  The set must hold each
    face's opposite and its fix-up sources, as the faces of a direction
    do (at a wall the neighbour is the element's own face)."""
    pos = {f: i for i, f in enumerate(faces)}
    lanes = lambda f: slice(pos[f] * Nfp, (pos[f] + 1) * Nfp)
    blocks = []
    for f in faces:
        blk = Bf[:, :, lanes(int(tab["opp"][f]))][tab["nbr_e"][f]]
        for fsrc, rows, src_e in tab["fix"][f]:
            blk[rows] = Bf[src_e][:, :, lanes(fsrc)]
        blocks.append(blk)
    return torch.cat(blocks, dim=2)


def wall_ghost(BP, nrm, bnd_lane):
    """The neighbour bundle with the impenetrable free-slip, insulating
    wall's ghost on wall lanes (where the gathered neighbour is the minus
    side): the normal momentum reflected, every other lane copied."""
    run = BP[:, 1] * nrm[:, 0] + BP[:, 2] * nrm[:, 1] + BP[:, 3] * nrm[:, 2]
    ghost = torch.cat(
        [BP[:, :1]]
        + [(BP[:, 1 + c] - 2 * run * nrm[:, c])[:, None] for c in range(3)]
        + [BP[:, 4:]], dim=1)
    return torch.where(bnd_lane[:, None, :], ghost, BP)


def rusanov(Bf, BP, nrm, nq: int, subtract: bool):
    """Rusanov flux ``[E, nq, X]`` of the Euler model from the two sides'
    bundles, lanes q (nq), p, the sound speed, p_ref (read only with
    ``subtract``): the central flux with p − p_ref (p without
    ``subtract``) in the momentum flux and each advected scalar past ρe
    (ρq_tot) carried by u·n, minus ½ max(|u·n| + c) times the jump."""
    def flux_n(Bs):
        rho = Bs[:, 0]
        inv = 1.0 / rho
        un = (Bs[:, 1] * inv * nrm[:, 0] + Bs[:, 2] * inv * nrm[:, 1]
              + Bs[:, 3] * inv * nrm[:, 2])
        pv = Bs[:, nq]
        p_eff = pv - Bs[:, nq + 2] if subtract else pv
        Fn = [rho * un]
        for c in range(3):
            Fn.append(Bs[:, 1 + c] * un + p_eff * nrm[:, c])
        Fn.append((Bs[:, 4] + pv) * un)
        Fn += [Bs[:, v] * un for v in range(5, nq)]
        return Fn, torch.abs(un) + Bs[:, nq + 1]

    FnM, cM = flux_n(Bf)
    FnP, cP = flux_n(BP)
    c = torch.maximum(cM, cP)
    return torch.stack([0.5 * (FnM[v] + FnP[v])
                        - 0.5 * c * (BP[:, v] - Bf[:, v])
                        for v in range(nq)], dim=1)


def lift(fstar, sM, liftT, MI):
    """The surface tendency −M⁻¹ L (sM · f*) ``[E, n, Np]`` of face
    fluxes ``[E, n, X]``."""
    E, n, X = fstar.shape
    lifted = torch.matmul((sM * fstar).reshape(E * n, X),
                          liftT).reshape(E, n, liftT.shape[1])
    return -(MI[:, None, :] * lifted)


def surface_tendency(dg, q, aux, t):
    """−M⁻¹ L (sM · f*) ``[E, 5, Np]`` of the dry AtmosModel on every face
    of ``dg``'s grid: the bundle (q, φ, p_ref where the reference state
    subtracts or a fused remainder needs it and, with a remainder, the
    reference ρe, ρ and T) extracted by one matmul against the 0/1
    lift matrix, its neighbour side gathered, the wall ghost, the face
    thermo of each side, the Rusanov flux and, with a remainder, the
    linear acoustic(-gravity) Rusanov flux taken out on the linear model's
    faces.  The dry model only (:func:`supports`): any other raises, its
    surface term is the node-gather pass's."""
    bl, g = dg.balance_law, dg.grid
    if not supports(dg):
        raise ValueError(
            "the var-major surface pass takes the dry AtmosModel with the "
            "Rusanov flux (fast_surface.supports); this configuration's "
            "surface term is the generic DG operator's node-gather pass, "
            "DGModel._generic_surface")
    ps, sp = bl.param_set, bl.aux_spec
    ops = dg.operators()
    E, Np, Nfp = g.nelem, g.Np, g.Nfp_max
    X = g.nface * Nfp
    rem = dg.remainder
    subtract = bl.ref_state.subtract_off
    lanes = [q, aux[:, sp.index("orientation.Phi")]]
    if reads_p_ref(dg):
        lanes.append(aux[:, sp.index("ref_state.p")])
    if rem is not None:
        lanes += [aux[:, sp.index(f"ref_state.{name}")]
                  for name in ("rhoe", "rho", "T")]
    B = torch.cat(lanes, dim=1)
    nvb = B.shape[1]
    Bf = torch.matmul(B.reshape(E * nvb, Np), g.lift).reshape(E, nvb, X)
    nrm = ops["nrm"]
    BP = wall_ghost(gather_faces(ops["tab"], Bf, tuple(range(g.nface)), Nfp),
                    nrm, ops["tab"]["bnd_lane"])

    def with_thermo(Bs):
        """q, p, c_s (, p_ref) lanes from q, φ (, p_ref)."""
        rho, ru, rhoe, phi = Bs[:, 0], Bs[:, 1:4], Bs[:, 4], Bs[:, 5]
        inv = 1.0 / rho
        e_int = (rhoe - 0.5 * (ru[:, 0] * (ru[:, 0] * inv)
                               + ru[:, 1] * (ru[:, 1] * inv)
                               + ru[:, 2] * (ru[:, 2] * inv))) * inv - phi
        T = td.air_temperature(ps, e_int)
        return torch.cat([Bs[:, :5], td.air_pressure(ps, T, rho)[:, None],
                          td.soundspeed_air(ps, T)[:, None], Bs[:, 6:7]],
                         dim=1)

    fstar = rusanov(with_thermo(Bf), with_thermo(BP), nrm, 5, subtract)
    if rem is not None:
        lin, ldir = rem
        gravity = isinstance(lin, AtmosAcousticGravityLinearModel)
        lf = direction_faces(ldir, g.dim)
        sl = slice(lf[0] * Nfp, (lf[-1] + 1) * Nfp)

        def with_linear(Bs):
            """q, φ, the linear energy coefficient and the reference sound
            speed from the remainder's lanes (q, φ, p_ref, ρe_ref, ρ_ref,
            T_ref)."""
            phi, p_r, rhoe_r, rho_r, T_r = (Bs[:, 5 + k] for k in range(5))
            coeff = (rhoe_r + p_r) / rho_r
            if not gravity:
                coeff = coeff - phi
            return torch.cat([Bs[:, :6], coeff[:, None],
                              td.soundspeed_air(ps, T_r)[:, None]], dim=1)

        fstar[:, :, sl] -= linear_rusanov(
            with_linear(Bf[:, :, sl]), with_linear(BP[:, :, sl]),
            nrm[:, :, sl], 5, 5, ps)
    return lift(fstar, ops["sM"], ops["liftT"], g.MI)


def linear_rusanov(Bf, BP, nrm, nq: int, i_lin: int, ps):
    """Rusanov flux ``[E, nq, L]`` of the linear acoustic(-gravity) model
    from the two sides' bundles ``[E, nvb, L]``: lanes q (nq) and, from
    ``i_lin``, φ, the linear energy coefficient and the reference sound
    speed (JAX fast_rhs.py:586-602).  p_L = ρ R_d T_0 + R_d/cv_d (ρe −
    ρφ); an advected scalar past ρe has no linear flux."""
    def flux_lin(Bs):
        rho, rhoe, phi = Bs[:, 0], Bs[:, 4], Bs[:, i_lin]
        pL = rho * ps.R_d * ps.T_0 + ps.R_d / ps.cv_d * (rhoe - rho * phi)
        un = Bs[:, 1] * nrm[:, 0] + Bs[:, 2] * nrm[:, 1] + Bs[:, 3] * nrm[:, 2]
        Fn = [un, pL * nrm[:, 0], pL * nrm[:, 1], pL * nrm[:, 2],
              Bs[:, i_lin + 1] * un] + [torch.zeros_like(un)] * (nq - 5)
        return Fn, Bs[:, i_lin + 2]

    FnM, cM = flux_lin(Bf)
    FnP, cP = flux_lin(BP)
    c = torch.maximum(cM, cP)
    return torch.stack([0.5 * (FnM[v] + FnP[v])
                        - 0.5 * c * (BP[:, v] - Bf[:, v])
                        for v in range(nq)], dim=1)
