"""The AtmosLESDefault, AtmosLESDefaultPerturbations and AtmosLESCore
diagnostics groups (port of ``climatemachine_tpu/diagnostics/
atmos_les.py``).  A collect computes every nodal field once, on the
state's device, and reduces it per vertical level with the quadrature
measure; the values reach the host in one copy.

Averaging convention (the JAX package's, not the Julia accumulation of
M·ρ·x over ΣM): profiles are Favre (density-weighted) averages x̃ =
⟨M ρ x⟩/⟨M ρ⟩, fluctuations are taken about x̃, second moments are
⟨M ρ x′y′⟩/⟨M ρ⟩; ``avg_rho`` is the plain area average ⟨M ρ⟩/⟨M⟩ and
``rho`` the density-weighted one.  The SGS fluxes are ``w_ht_sgs =
−(D_t ∇h_tot)_z`` and ``w_qt_sgs = −(D_t ∇q_tot)_z``, Favre-averaged,
from the DG operator's gradient (``DGModel.spatial_gradient``), the
model's gradient flux and the closure's ``viscosity``.

Cloud diagnostics: ``cld_frac(z)``, the area fraction of nodes with
condensate per level; ``cld_cover``, the area fraction of vertical
node-columns holding any; ``cld_top`` / ``cld_base``, the largest and
smallest altitude with condensate (NaN when the domain is cloud-free);
``lwp``/``iwp``/``rwp``/``swp``, the vertical integral of ⟨ρ q_x⟩(z)
with the per-level vertical measure (Σ_level M) / A_horz.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from climatemachine_tpu_torch.diagnostics.machine import OutputGroup, to_host
from climatemachine_tpu_torch.physics import thermodynamics as td


# --- per-level reduction helpers ---------------------------------------------

def _lev_reshape(grid, f):
    """``[E, Np]`` → ``[nh, nv, Nq3, Nq1·Nq2]`` (level = (nv, Nq3))."""
    Nq1, Nq2, Nq3 = grid.Nq
    return f.reshape(grid.n_horz, grid.n_vert, Nq3, Nq2 * Nq1)


def _lev_sum(grid, f):
    """The sum over the horizontal per vertical level: ``[E, Np]`` →
    ``[nlev]``."""
    nlev = grid.n_vert * grid.Nq[2]
    return torch.sum(_lev_reshape(grid, f), dim=(0, 3)).reshape(nlev)


def _per_node(grid, prof):
    """A profile ``[nlev]`` broadcast to the nodes ``[E, Np]``."""
    Nq1, Nq2, Nq3 = grid.Nq
    p4 = prof.reshape(grid.n_vert, Nq3)[None, :, :, None]
    return p4.expand(grid.n_horz, grid.n_vert, Nq3, Nq2 * Nq1).reshape(
        grid.nelem, grid.Np)


class _ProfileGroup(OutputGroup):
    """Shared machinery: a collect → {name: profile ``[nlev]`` or
    scalar}, written with a ``z`` dimension."""

    name = "AtmosLES"

    def __init__(self, dg, writer=None, out_path: Optional[str] = None):
        grid = dg.grid
        if grid.n_vert is None or grid.n_horz is None:
            raise ValueError(f"{self.name} diagnostics need a stacked grid")
        self.dg = dg
        self.model = dg.balance_law
        self.grid = grid
        self.writer = writer
        self.out_path = out_path
        # z per level (area average of nodal z; exact for flat stacks)
        z = grid.coords[..., grid.dim - 1].detach().cpu().double()
        M = grid.M.detach().cpu().double()
        Mz = _lev_sum(grid, M)
        self.z_levels = (_lev_sum(grid, M * z) / Mz).numpy()

    # -- nodal fields shared by the default and core groups -------------------
    def _nodal(self, q, aux, t):
        bl, g = self.model, self.grid
        ps, sp = bl.param_set, bl.prog_spec
        rho = sp.get(q, "rho")
        u = sp.get(q, "rhou") / rho[:, None]
        T, p, _, pp = bl.thermo_full(q, aux)
        e_int = td.internal_energy(ps, T, pp)
        if bl.physics.energy.is_theta:
            e_tot = e_int + 0.5 * torch.sum(u * u, dim=1) + bl.aux_spec.get(
                aux, "orientation.Phi")
        else:
            e_tot = sp.get(q, "rhoe") / rho
        R_m = td.gas_constant_air(ps, pp)
        out = {
            "rho": rho, "u": u[:, 0], "v": u[:, 1], "w": u[:, 2],
            "temp": T, "pres": p,
            "thd": td.dry_pottemp(ps, T, p, pp),
            "et": e_tot, "ei": e_int,
            "ht": e_tot + R_m * T, "hi": e_int + R_m * T,
            "z": g.coords[..., g.dim - 1].to(rho.dtype),
        }
        if pp is not None:
            out.update({
                "qt": pp.tot, "ql": pp.liq, "qi": pp.ice, "qv": pp.vap,
                "thv": td.virtual_pottemp(ps, T, p, pp),
                "thl": td.liquid_ice_pottemp(ps, T, p, pp),
            })
        for nm, key in (("qr", "precipitation.rhoq_rai"),
                        ("qs", "precipitation.rhoq_sno")):
            try:
                out[nm] = sp.get(q, key) / rho
            except KeyError:
                pass
        turb = bl.physics.turbulence
        if turb is not None:
            grad = self.dg.spatial_gradient(q, aux, t)
            gf = bl.compute_gradient_flux(grad, q, aux, t)
            _, D_t = turb.viscosity(bl, q, gf, aux, t)
            d_h = -D_t * bl.gf_spec.get(gf, "d_h_tot")
            out["w_ht_sgs"] = d_h[:, 2]
            if pp is not None:
                try:
                    d_q = -D_t * bl.gf_spec.get(gf, "moisture.d_q_tot")
                    out["w_qt_sgs"] = d_q[:, 2]
                except KeyError:
                    pass
        return out

    def collect(self, q, aux, t=0.0):
        return to_host(self._collect_impl(q, aux, t))

    def _layout(self, vals):
        return {"z": self.z_levels}, {
            k: (("z",) if np.ndim(v) else (), np.float64)
            for k, v in vals.items()}


class AtmosLESDefaultGroup(_ProfileGroup):
    """The "AtmosLESDefault" group.

    Profiles (z): u v w avg_rho rho temp pres thd et ei ht hi w_ht_sgs,
    var_u var_v var_w w3 tke var_ei cov_w_u cov_w_v cov_w_rho cov_w_thd
    cov_w_ei; with moisture also qt ql qi qv thv thl w_qt_sgs var_qt
    var_thl cov_w_qt cov_w_ql cov_w_qi cov_w_qv cov_w_thv cov_w_thl
    cov_qt_thl cov_qt_ei, and qr/qs with precipitation; plus cld_frac.
    Scalars: cld_cover, cld_top, cld_base, lwp, iwp (rwp, swp with
    precipitation)."""

    name = "AtmosLESDefault"

    def _collect_impl(self, q, aux, t):
        g = self.grid
        nd = self._nodal(q, aux, t)
        rho = nd["rho"]
        M = g.M.to(rho.dtype)
        MH_z = _lev_sum(g, M)
        Mrho_z = _lev_sum(g, M * rho)

        def area_avg(x):
            return _lev_sum(g, M * x) / MH_z

        def favre(x):
            return _lev_sum(g, M * rho * x) / Mrho_z

        out = {"avg_rho": area_avg(rho), "rho": favre(rho)}
        simple = ["u", "v", "w", "temp", "pres", "thd", "et", "ei", "ht",
                  "hi", "w_ht_sgs", "qt", "ql", "qi", "qv", "thv", "thl",
                  "w_qt_sgs", "qr", "qs"]
        means = {}
        for k in simple:
            if k in nd:
                means[k] = favre(nd[k])
                out[k] = means[k]

        fl = {k: nd[k] - _per_node(g, means[k])
              for k in ("u", "v", "w", "ei", "thd")}
        rp = rho - _per_node(g, out["avg_rho"])
        out["var_u"] = favre(fl["u"] ** 2)
        out["var_v"] = favre(fl["v"] ** 2)
        out["var_w"] = favre(fl["w"] ** 2)
        out["w3"] = favre(fl["w"] ** 3)
        out["tke"] = 0.5 * (out["var_u"] + out["var_v"] + out["var_w"])
        out["var_ei"] = favre(fl["ei"] ** 2)
        out["cov_w_u"] = favre(fl["w"] * fl["u"])
        out["cov_w_v"] = favre(fl["w"] * fl["v"])
        out["cov_w_rho"] = favre(fl["w"] * rp)
        out["cov_w_thd"] = favre(fl["w"] * fl["thd"])
        out["cov_w_ei"] = favre(fl["w"] * fl["ei"])

        if "qt" in nd:
            flm = {k: nd[k] - _per_node(g, means[k])
                   for k in ("qt", "ql", "qi", "qv", "thv", "thl")}
            out["var_qt"] = favre(flm["qt"] ** 2)
            out["var_thl"] = favre(flm["thl"] ** 2)
            for k in ("qt", "ql", "qi", "qv", "thv", "thl"):
                out["cov_w_" + k] = favre(fl["w"] * flm[k])
            out["cov_qt_thl"] = favre(flm["qt"] * flm["thl"])
            out["cov_qt_ei"] = favre(flm["qt"] * fl["ei"])

            # cloud diagnostics
            has_cond = (nd["ql"] + nd["qi"]) > 0.0
            z = nd["z"]
            out["cld_frac"] = area_avg(has_cond.to(rho.dtype))
            colM = torch.sum(_lev_reshape(g, M), dim=(1, 2))  # [nh, nq12]
            col_cld = torch.any(torch.any(_lev_reshape(g, has_cond), dim=1),
                                dim=1).to(rho.dtype)
            out["cld_cover"] = torch.sum(colM * col_cld) / torch.sum(colM)
            inf = torch.full_like(z, float("inf"))
            nan = torch.full((), float("nan"), dtype=rho.dtype,
                             device=rho.device)
            any_cld = torch.any(has_cond)
            out["cld_top"] = torch.where(
                any_cld, torch.max(torch.where(has_cond, z, -inf)), nan)
            out["cld_base"] = torch.where(
                any_cld, torch.min(torch.where(has_cond, z, inf)), nan)

            # water paths: the integral of <rho q>(z) dz; the per-level
            # vertical measure Mvert = Sum_level(M)/A, A = Sum(M)/H
            H = torch.max(z) - torch.min(z)
            A = torch.sum(M) / H
            Mvert = _lev_sum(g, M) / A
            for nm, qk in (("lwp", "ql"), ("iwp", "qi"),
                           ("rwp", "qr"), ("swp", "qs")):
                if qk in nd:
                    out[nm] = torch.sum(area_avg(rho * nd[qk]) * Mvert)
        return out


class AtmosLESDefaultPerturbationsGroup(_ProfileGroup):
    """The "AtmosLESDefaultPerturbations" group: pointwise deviations of
    u v w avg_rho temp pres thd et ei ht hi (+ qt ql qv thv thl with
    moisture) from their horizontal (Favre) averages, on the x-y-z grid
    of ``interpolator`` (an ``InterpolationBrick``)."""

    name = "AtmosLESDefaultPerturbations"

    def __init__(self, dg, interpolator, writer=None, out_path=None):
        self.interpolator = interpolator
        super().__init__(dg, writer, out_path)

    def _collect_impl(self, q, aux, t):
        g = self.grid
        nd = self._nodal(q, aux, t)
        rho = nd["rho"]
        M = g.M.to(rho.dtype)
        Mrho_z = _lev_sum(g, M * rho)

        def favre(x):
            return _lev_sum(g, M * rho * x) / Mrho_z

        keys = ["u", "v", "w", "temp", "pres", "thd", "et", "ei", "ht",
                "hi", "qt", "ql", "qv", "thv", "thl"]
        out = {"avg_rho_prime": self.interpolator(
            rho - _per_node(g, _lev_sum(g, M * rho) / _lev_sum(g, M)))}
        for k in keys:
            if k in nd:
                out[k + "_prime"] = self.interpolator(
                    nd[k] - _per_node(g, favre(nd[k])))
        return out

    def _layout(self, vals):
        dims = {d: np.asarray(v)
                for d, v in zip(("x", "y", "z"), self.interpolator.xyz)}
        return dims, {k: (tuple(dims), np.float64) for k in vals}


class AtmosLESCoreGroup(_ProfileGroup):
    """The "AtmosLESCore" group: conditional (cloud-core: q_liq > 0 and
    w > 0) horizontal averages.

    Profiles: core_frac, u_core v_core w_core avg_rho_core rho_core
    qt_core ql_core thv_core thl_core ei_core, var_{u,v,w,qt,thl,ei}_core,
    cov_w_{rho,qt,thl,ei}_core, cov_qt_{thl,ei}_core.  Conditional means
    are ⟨M ρ x ind⟩/⟨M ρ ind⟩; levels with no core nodes report 0."""

    name = "AtmosLESCore"

    def _collect_impl(self, q, aux, t):
        g = self.grid
        nd = self._nodal(q, aux, t)
        if "ql" not in nd:
            raise ValueError("AtmosLESCore requires a moisture model")
        rho = nd["rho"]
        M = g.M.to(rho.dtype)
        ind = ((nd["ql"] > 0.0) & (nd["w"] > 0.0)).to(rho.dtype)
        MH_z = _lev_sum(g, M)
        Mi_z = _lev_sum(g, M * ind)
        Mrhoi_z = _lev_sum(g, M * rho * ind)
        eps = 1e-300 if rho.dtype == torch.float64 else 1e-30

        def carea(x):
            return _lev_sum(g, M * ind * x) / torch.clamp_min(Mi_z, eps)

        def cfavre(x):
            return _lev_sum(g, M * rho * ind * x) / torch.clamp_min(
                Mrhoi_z, eps)

        out = {"core_frac": Mi_z / MH_z,
               "avg_rho_core": carea(rho), "rho_core": cfavre(rho)}
        means = {}
        for k in ("u", "v", "w", "qt", "ql", "thv", "thl", "ei"):
            means[k] = cfavre(nd[k])
            out[k + "_core"] = means[k]

        fl = {k: nd[k] - _per_node(g, means[k]) for k in means}
        rp = rho - _per_node(g, out["avg_rho_core"])
        for k in ("u", "v", "w", "qt", "thl", "ei"):
            out[f"var_{k}_core"] = cfavre(fl[k] ** 2)
        out["cov_w_rho_core"] = cfavre(fl["w"] * rp)
        for k in ("qt", "thl", "ei"):
            out[f"cov_w_{k}_core"] = cfavre(fl["w"] * fl[k])
        out["cov_qt_thl_core"] = cfavre(fl["qt"] * fl["thl"])
        out["cov_qt_ei_core"] = cfavre(fl["qt"] * fl["ei"])
        return out
