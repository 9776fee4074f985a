"""EDMF, the eddy-diffusivity mass-flux turbulence-convection scheme (port
of ``climatemachine_tpu/atmos/edmf.py``: ``lamb_smooth_minimum`` :52,
``percentile_bounds_mean_norm`` :64, the sub-models :77-160 and ``EDMF``
:162-981).

``N_up`` updrafts (prognostic area ρa, vertical momentum ρaw, ρaθ_liq
and, moist, ρaq_tot) and an environment (prognostic TKE and second
moments of θ_liq and q_tot), advected vertically, exchanging mass by
entrainment and detrainment (Cohen et al. 2020), closed by an eddy
diffusivity from a multi-scale mixing length (Lopez-Gomez et al. 2020)
and a perturbation pressure (He et al. 2020); ``Coupled()`` feeds the
resulting SGS fluxes back into the grid-mean momentum, energy and
moisture.  The surface injects updraft area and the u*-scaled TKE
through the wall ghost state; the second-order wall fluxes of the EDMF
lanes are 0, and positivity of its lanes is TMAR's job between steps
(:meth:`EDMF.filter_variables` names the lanes).

Var-major, as the model's hooks: the updraft lanes ``[E, N_up, L]`` (the
updraft axis is the variable axis, kept even at ``N_up = 1``, so the
flattened names and lane order are the JAX package's), environment and
grid-mean scalars ``[E, L]``, fluxes ``[E, 3, n, L]``, the gradient
``[E, 3, ng, L]`` and the gradient flux ``[E, ngf, L]``, of which EDMF
keeps the vertical derivative only: one lane a scalar, ``N_up`` for
∂w_up/∂z.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Tuple

import torch

from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.utils.variables import VarSpec

_TOL = 1e-8
#: the results kept for reuse, per memoized function
_MEMO_SIZE = 6

#: lambertw((n − 1)/e) for the smooth minimum of n = 2 and 3 lengths
_LAMBERT_W = {2: 0.2784645427610738, 3: 0.46305551336554884}


def lamb_smooth_minimum(l, frac_upper_bound, reg_min):
    """The regularized smooth minimum of ``l`` over its last axis
    (Lopez-Gomez et al. 2020, Appendix A)."""
    lw = _LAMBERT_W[l.shape[-1]]
    xmin = torch.amin(l, dim=-1, keepdim=True)
    lam = torch.clamp_min(xmin * frac_upper_bound / lw, reg_min)
    w = torch.exp(-(l - xmin) / lam)
    return torch.sum(l * w, dim=-1) / torch.sum(w, dim=-1)


def percentile_bounds_mean_norm(low, high):
    """The mean of a standard normal conditioned to (Φ⁻¹(low),
    Φ⁻¹(high)), in float64."""
    a, b = torch.special.ndtri(torch.tensor([low, high],
                                            dtype=torch.float64)).tolist()
    phi = lambda x: math.exp(-0.5 * x * x) / math.sqrt(2 * math.pi)
    return (phi(a) - phi(b)) / (high - low)


# --- the sub-models ------------------------------------------------------------

@dataclass(frozen=True)
class EntrainmentDetrainment:
    """Cohen et al. (2020)."""
    c_lambda: float = 0.3      # entrainment TKE scale
    c_eps: float = 0.13        # entrainment factor
    c_del: float = 0.52        # detrainment factor
    c_t: float = 0.1           # turbulent entrainment factor
    beta: float = 2.0          # detrainment RH power
    mu_0: float = 4e-4         # logistic scale [1/s]
    chi: float = 0.25          # updraft mixing fraction
    w_min: float = 0.1         # minimum updraft velocity
    lim_eps: float = 1e-4      # area limiter scale (unused: TMAR)
    lim_amp: float = 10.0


@dataclass(frozen=True)
class PressureModel:
    """He et al. (2020)."""
    alpha_d: float = 10.0      # drag
    alpha_a: float = 0.1       # advection
    alpha_b: float = 0.12      # buoyancy
    H_up_min: float = 500.0    # least diagnosed updraft height


@dataclass(frozen=True)
class MixingLengthModel:
    """Lopez-Gomez et al. (2020)."""
    c_d: float = 0.22          # dissipation
    c_m: float = 0.14          # eddy viscosity
    c_b: float = 0.63          # static stability
    a1: float = 0.2            # stability function exponent
    a2: float = 100.0          # stability function coefficient
    kappa: float = 0.4         # von Karman
    omega_pr: float = 53.0 / 13.0
    Pr_n: float = 0.74
    Ri_c: float = 0.25
    smin_ub: float = 0.1
    smin_rm: float = 1.5
    max_length: float = 1e6
    random_minval: float = 1e-9


@dataclass(frozen=True)
class SurfaceModel:
    """The BOMEX surface."""
    a: float = 0.1             # total updraft surface area
    psi_phi_stab: float = 8.3
    kappa_star2: float = 3.75
    theta_liq: float = 299.1
    q_tot: float = 22.45e-3
    shf: float = 9.5           # sensible heat flux [W/m²]
    lhf: float = 147.2         # latent heat flux [W/m²]
    ustar: float = 0.28
    obukhov_length: float = 0.0
    zLL: float = 60.0          # height of the lowest nodal level


@dataclass(frozen=True)
class NeutralDrySurfaceModel:
    """A dry neutral surface: no scalar fluxes, the TKE set by u*."""
    a: float = 0.1
    kappa_star2: float = 3.75
    ustar: float = 0.3
    zLL: float = 60.0
    obukhov_length: float = 0.0
    psi_phi_stab: float = 8.3
    shf: float = 0.0
    lhf: float = 0.0


@dataclass(frozen=True)
class SubdomainModel:
    a_min: float = 0.0
    a_max: float = 1.0


class Decoupled:
    """The SGS fluxes do not feed back on the grid mean."""


class Coupled:
    """The SGS fluxes modify the grid-mean momentum, energy and
    moisture."""


def _put(out, spec, name, val):
    """``out`` (in place) with lanes ``name`` set to ``val`` (``[E, L]``
    for one lane, ``[E, k, L]`` for k)."""
    sl = spec.index(name)
    out[:, sl] = val if val.dim() == 3 else val[:, None]


class EDMF:
    """The EDMF model, a ``turbconv`` of
    :class:`~climatemachine_tpu_torch.atmos.model.AtmosPhysics` (with a
    turbulence closure: its gradient pass carries EDMF's lanes)."""

    def __init__(self, N_up: int = 1,
                 entr_detr: EntrainmentDetrainment = None,
                 pressure: PressureModel = None,
                 surface=None,
                 mix_len: MixingLengthModel = None,
                 subdomains: SubdomainModel = None,
                 coupling=None):
        self.N_up = N_up
        self.entr_detr = entr_detr or EntrainmentDetrainment()
        self.pressure = pressure or PressureModel()
        self.surface = surface or SurfaceModel()
        self.mix_len = mix_len or MixingLengthModel()
        self.subdomains = subdomains or SubdomainModel()
        self.coupling = coupling or Decoupled()
        self._memo = {}
        a = self.surface.a
        #: each updraft's surface anomaly in standard deviations
        self.upd_surface_std = tuple(
            percentile_bounds_mean_norm(1 - a + i * a / N_up,
                                        1 - a + (i + 1) * a / N_up)
            if a > 0 else 0.0 for i in range(N_up))

    # --- schemas (the moist lanes with EquilMoist) ----------------------------
    @staticmethod
    def _moist(model) -> bool:
        return model.moist

    def vars_prognostic(self, moist: bool) -> VarSpec:
        N = (self.N_up,)
        f = dict(up_rhoa=N, up_rhoaw=N, up_rhoatheta_liq=N,
                 en_rhoatke=1, en_rhoatheta_liq_cv=1)
        if moist:
            f["up_rhoaq_tot"] = N
            f["en_rhoaq_tot_cv"] = 1
            f["en_rhoatheta_liq_q_tot_cv"] = 1
        return VarSpec(**f)

    def vars_aux(self) -> VarSpec:
        return VarSpec(up_T=(self.N_up,), en_T=1)

    def vars_gradient(self, moist: bool) -> VarSpec:
        f = dict(up_w=(self.N_up,), en_theta_liq=1, en_w=1, en_tke=1,
                 en_theta_liq_cv=1, en_thetav=1, en_h_tot=1, u=1, v=1)
        if moist:
            f["en_q_tot"] = 1
            f["en_q_tot_cv"] = 1
            f["en_theta_liq_q_tot_cv"] = 1
        return VarSpec(**f)

    def vars_gradient_flux(self, moist: bool) -> VarSpec:
        f = dict(up_dwdz=(self.N_up,), en_dthetadz=1, en_dwdz=1,
                 en_dtkedz=1, en_dtheta_cvdz=1, en_dthetavdz=1,
                 en_dhtotdz=1, dudz=1, dvdz=1)
        if moist:
            f["en_dqtdz"] = 1
            f["en_dqt_cvdz"] = 1
            f["en_dthqt_cvdz"] = 1
        return VarSpec(**f)

    # --- small helpers -----------------------------------------------------------
    @staticmethod
    def _safe_div(num, den, alt=0.0):
        ok = torch.abs(den) > _TOL
        return torch.where(ok, num / torch.where(ok, den, 1.0), alt)

    @staticmethod
    def _filter_w(w, w_min):
        """|result| ≥ w_min, the sign of w kept (− where w < 0)."""
        m = torch.clamp_min(torch.abs(w), w_min)
        return torch.where(w < 0, -m, m)

    @staticmethod
    def _key(tensors):
        """The identity and version of each tensor, or None for inference
        tensors (which have no version counter)."""
        if any(a.is_inference() for a in tensors):
            return None
        return [(id(a), a._version) for a in tensors]

    def _memoized(self, name, fn, *args):
        """``fn(*args)``, reused while ``name`` is asked for again with the
        same tensors unmodified (the volume's gradient argument, F₂ and
        source within one RHS share their subdomain thermo and closures,
        as CSE shares them in the JAX package's traced RHS)."""
        key = self._key(args[1:])
        for k, _, out in self._memo.get(name, ()):
            if k == key:
                return out
        out = fn(*args)
        self._remember(name, out, *args)
        return out

    def _remember(self, name, out, *args):
        """Keep ``out`` for ``name`` at ``args``, with the _MEMO_SIZE − 1
        newest before it (an RHS asks at the volume and at each face
        side)."""
        key = self._key(args[1:])
        if key is not None:
            # the tensors are held so that their ids are not reused
            entries = self._memo.setdefault(name, [])
            entries.insert(0, (key, args, out))
            del entries[_MEMO_SIZE:]

    @staticmethod
    def _tc(model, q, name):
        return model.prog_spec.get(q, f"turbconv.{name}")

    def _environment(self, model, q):
        """(a_en, w_en): the environment's area and vertical velocity."""
        sp = model.prog_spec
        rho = sp.get(q, "rho")
        a_en = torch.clamp_min(
            1.0 - torch.sum(self._tc(model, q, "up_rhoa"), dim=1) / rho, _TOL)
        rhow = sp.get(q, "rhou")[:, 2]
        w_en = (rhow - torch.sum(self._tc(model, q, "up_rhoaw"), dim=1)) \
            / (a_en * rho)
        return a_en, w_en

    def _rhoa_up(self, model, q):
        """The updrafts' ρa with a clipped to the subdomain bounds."""
        rho = model.prog_spec.get(q, "rho")[:, None]
        a = torch.clamp(self._tc(model, q, "up_rhoa") / rho,
                        self.subdomains.a_min, self.subdomains.a_max)
        return rho * a

    def _subdomain_thermo(self, model, q, aux):
        """Thermo of the updrafts and the environment at the grid-mean
        pressure."""
        return self._memoized("sub", self._subdomain_thermo_of, model, q,
                              aux)

    def _subdomain_thermo_of(self, model, q, aux):
        ps = model.param_set
        moist = self._moist(model)
        T_gm, p_gm, u_gm, pp_gm = model.thermo_full(q, aux)
        rho = model.prog_spec.get(q, "rho")
        theta_liq_gm = td.liquid_ice_pottemp(ps, T_gm, p_gm, pp_gm)
        q_tot_gm = pp_gm.tot if pp_gm is not None else None
        a_en, w_en = self._environment(model, q)

        rhoa = self._tc(model, q, "up_rhoa")
        void = rhoa <= _TOL
        rhoath = self._tc(model, q, "up_rhoatheta_liq")
        theta_liq_up = torch.where(void, theta_liq_gm[:, None],
                                   self._safe_div(rhoath, rhoa))
        theta_liq_en = (theta_liq_gm - torch.sum(
            torch.where(void, 0.0, rhoath), dim=1) / rho) / a_en
        # the updrafts and the environment side by side on the updraft
        # axis (lane N_up the environment): one inversion for all
        N, p = self.N_up, p_gm[:, None]
        theta_liq = torch.cat([theta_liq_up, theta_liq_en[:, None]], dim=1)
        if moist:
            rhoaq = self._tc(model, q, "up_rhoaq_tot")
            q_tot_up = torch.where(void, q_tot_gm[:, None],
                                   self._safe_div(rhoaq, rhoa))
            q_tot_en = torch.clamp((q_tot_gm - torch.sum(
                torch.where(void, 0.0, rhoaq), dim=1) / rho) / a_en,
                0.0, 1.0)
            q_tot = torch.cat([q_tot_up, q_tot_en[:, None]], dim=1)
            T = td.temperature_from_theta_liq(ps, p, theta_liq, q_tot)
            pp = td.phase_partition_equil(ps, T, p / (ps.R_d * T), q_tot)
            rho_sub = p / (td.gas_constant_air(ps, pp) * T)
            pp_up = td.PhasePartition(*(x[:, :N] for x in pp))
            pp_en = td.PhasePartition(*(x[:, N] for x in pp))
        else:
            q_tot_up = q_tot_en = pp_up = pp_en = None
            T = td.temperature_from_theta_liq(ps, p, theta_liq)
            rho_sub = p / (ps.R_d * T)
        T_up, T_en = T[:, :N], T[:, N]
        rho_up, rho_en = rho_sub[:, :N], rho_sub[:, N]
        return SimpleNamespace(
            T_gm=T_gm, p_gm=p_gm, pp_gm=pp_gm, u_gm=u_gm,
            theta_liq_gm=theta_liq_gm, q_tot_gm=q_tot_gm,
            a_en=a_en, w_en=w_en,
            theta_liq_up=theta_liq_up, q_tot_up=q_tot_up,
            theta_liq_en=theta_liq_en, q_tot_en=q_tot_en,
            T_up=T_up, T_en=T_en, rho_up=rho_up, rho_en=rho_en,
            pp_up=pp_up, pp_en=pp_en)

    def _buoyancy(self, model, q, aux, sub):
        """The subdomains' buoyancies less the grid mean's: (b_up, b_en)."""
        ps = model.param_set
        rho = model.prog_spec.get(q, "rho")
        rho_ref = model.aux_spec.get(aux, "ref_state.rho")
        b_en = -ps.grav * (sub.rho_en - rho_ref) / rho
        b_up = -ps.grav * (sub.rho_up - rho_ref[:, None]) / rho[:, None]
        a_up = self._tc(model, q, "up_rhoa") / rho[:, None]
        b_gm = sub.a_en * b_en + torch.sum(a_up * b_up, dim=1)
        return b_up - b_gm[:, None], b_en - b_gm

    # --- the closures ------------------------------------------------------------
    def _entr_detr(self, model, q, aux, sub, b_up, b_en):
        """(E_dyn, D_dyn, E_trb): dynamic entrainment and detrainment and
        turbulent entrainment (Cohen et al. 2020)."""
        ps = model.param_set
        ed = self.entr_detr
        rho = model.prog_spec.get(q, "rho")
        rhoa_raw = self._tc(model, q, "up_rhoa")
        rhoatke = self._tc(model, q, "en_rhoatke")
        a_en, w_en = sub.a_en, sub.w_en
        a_up = rhoa_raw / rho[:, None]
        w_up = self._safe_div(self._tc(model, q, "up_rhoaw"), rhoa_raw)

        tke_en = torch.clamp_min(rhoatke, 0.0) / rho / a_en
        sqrt_tke = torch.sqrt(tke_en)
        dw = self._filter_w(w_up - w_en[:, None], ed.w_min)
        db = b_up - b_en[:, None]

        if self._moist(model):
            RH_up = td.relative_humidity(ps, sub.T_up, sub.p_gm[:, None],
                                         sub.pp_up)
            RH_en = td.relative_humidity(ps, sub.T_en, sub.p_gm,
                                         sub.pp_en)[:, None]
            cond = (sub.pp_en.liq + sub.pp_en.ice)[:, None] \
                + sub.pp_up.liq + sub.pp_up.ice
            c_del = torch.sign(cond) * ed.c_del
            b = ed.beta
            M_eps = c_del * torch.clamp_min(RH_en ** b - RH_up ** b,
                                            0.0) ** (1.0 / b)
            M_del = c_del * torch.clamp_min(RH_up ** b - RH_en ** b,
                                            0.0) ** (1.0 / b)
        else:
            M_eps = M_del = torch.zeros_like(w_up)

        mu_ij = (ed.chi - a_up / (a_up + a_en[:, None])) * db / dw
        D_eps = ed.c_eps / (1.0 + torch.exp(-mu_ij / ed.mu_0))
        D_del = ed.c_eps / (1.0 + torch.exp(mu_ij / ed.mu_0))

        lam_w = torch.abs(db / dw)
        lam_tke = ed.c_lambda * torch.abs(
            db / (torch.clamp_min(rhoatke / rho, 0.0) + ed.w_min)[:, None])
        lam = lamb_smooth_minimum(torch.stack([lam_w, lam_tke], dim=-1),
                                  self.mix_len.smin_ub, self.mix_len.smin_rm)

        E_trb = torch.clamp_min(2.0 * rhoa_raw * ed.c_t * sqrt_tke[:, None]
                                / self.pressure.H_up_min, 0.0)
        E_dyn = torch.clamp_min(rhoa_raw * lam * (D_eps + M_eps), 0.0)
        D_dyn = torch.clamp_min(rhoa_raw * lam * (D_del + M_del), 0.0)
        return E_dyn, D_dyn, E_trb

    def _buoyancy_gradients(self, model, q, gf, aux, sub):
        """(∂b/∂z, N²_eff) of the environment (the cloud fraction 1 where
        it holds condensate)."""
        ps = model.param_set
        rho = model.prog_spec.get(q, "rho")
        gfs = model.gf_spec
        dthdz = gfs.get(gf, "turbconv.en_dthetadz")
        dthvdz = gfs.get(gf, "turbconv.en_dthetavdz")
        pre = ps.grav * ps.R_d * rho / sub.p_gm * td.exner(ps, sub.p_gm,
                                                           sub.pp_en)
        theta_virt = td.virtual_pottemp(ps, sub.T_en, sub.p_gm, sub.pp_en)
        if not self._moist(model):
            return pre * dthdz, ps.grav / theta_virt * dthvdz
        dqtdz = gfs.get(gf, "turbconv.en_dqtdz")
        eps_v = 1.0 / ps.molmass_ratio
        q_tot = sub.q_tot_en
        lv = td.latent_heat_vapor(ps, sub.T_en)
        cpm = td.cp_m(ps, sub.pp_en)
        q_vap = sub.pp_en.vap
        th_dry = td.dry_pottemp(ps, sub.T_en, sub.p_gm, sub.pp_en)
        cloud = (sub.pp_en.liq + sub.pp_en.ice) > 0
        db_dthl_dry = pre * (1.0 + (eps_v - 1.0) * q_tot)
        db_dqt_dry = pre * sub.theta_liq_en * (eps_v - 1.0)
        num = pre * (1.0 + eps_v * (1.0 + lv / ps.R_v / sub.T_en) * q_vap
                     - q_tot)
        den = 1.0 + lv * lv / cpm / ps.R_v / sub.T_en ** 2 * q_vap
        db_dthl_cl = num / den
        db_dqt_cl = (lv / cpm / sub.T_en * db_dthl_cl - pre) * th_dry
        cf = cloud.to(rho.dtype)
        db_dthl = cf * db_dthl_cl + (1 - cf) * db_dthl_dry
        db_dqt = cf * db_dqt_cl + (1 - cf) * db_dqt_dry
        dbdz = db_dthl * dthdz + db_dqt * dqtdz
        dthvl_dz = (1.0 + (eps_v - 1.0) * q_tot) * dthdz \
            + (eps_v - 1.0) * sub.theta_liq_en * dqtdz
        dthv_dthvl = torch.exp(lv * sub.pp_en.liq / cpm / sub.T_en)
        N2_eff = ps.grav / theta_virt * (
            (1 - cf) * dthvdz + cf * dthvl_dz * dthv_dthvl)
        return dbdz, N2_eff

    def _mixing_length(self, model, q, gf, aux, sub, D_dyn, E_trb, shear2):
        """(l_mix, ∂b/∂z, Pr_t): the smooth minimum of the stability,
        wall and TKE-balance lengths (Lopez-Gomez et al. 2020)."""
        ml = self.mix_len
        ps = model.param_set
        rho = model.prog_spec.get(q, "rho")
        a_en, w_en = sub.a_en, sub.w_en
        rhoatke = self._tc(model, q, "en_rhoatke")
        tke_en = torch.clamp_min(rhoatke, 0.0) / rho / a_en
        z = model.aux_spec.get(aux, "orientation.Phi") / ps.grav

        dbdz, N2_eff = self._buoyancy_gradients(model, q, gf, aux, sub)
        grad_Ri = torch.clamp_max(
            dbdz / torch.clamp_min(shear2, 1.0 / ml.max_length), ml.Ri_c)
        disc = torch.sqrt(torch.clamp_min(
            (1 + ml.omega_pr * grad_Ri) ** 2 - 4 * grad_Ri, 0.0))
        # the conjugate form of 2Ri/(1 + ωRi − √disc), which cancels
        # catastrophically as Ri → 0⁺
        factor = torch.where(grad_Ri > 0,
                             (1 + ml.omega_pr * grad_Ri + disc) / 2, 1.0)
        Pr_t = ml.Pr_n * factor

        # L1: static stability
        stable = N2_eff > _TOL
        L_N = torch.where(
            stable,
            torch.clamp_max(ml.c_b * torch.sqrt(tke_en)
                            / torch.sqrt(torch.where(stable, N2_eff, 1.0)),
                            ml.max_length),
            ml.max_length)

        # L2: law of the wall
        L_W = ml.kappa * torch.clamp_min(z, 5.0) \
            / (math.sqrt(self.surface.kappa_star2) * ml.c_m)
        ol = self.surface.obukhov_length
        if ol < -_TOL:
            L_W = L_W * torch.clamp_max((1.0 - ml.a2 * z / ol) ** ml.a1,
                                        1.0 / ml.kappa)

        # L3: the TKE production/dissipation balance
        a = ml.c_m * (shear2 - dbdz / Pr_t) * torch.sqrt(tke_en)
        rhoa_raw = self._tc(model, q, "up_rhoa")
        w_up = self._safe_div(self._tc(model, q, "up_rhoaw"), rhoa_raw)
        dw = w_up - w_en[:, None]
        b = torch.sum(
            D_dyn / rho[:, None] / a_en[:, None]
            * (dw * dw / 2 - tke_en[:, None])
            - dw * E_trb / rho[:, None] * w_en[:, None] / a_en[:, None],
            dim=1)
        c_neg = ml.c_d * tke_en * torch.sqrt(tke_en)
        disc3 = b * b + 4.0 * a * c_neg
        branch_quad = (torch.abs(a) > ml.random_minval) & (disc3 > 0)
        l_quad = torch.clamp_min(self._safe_div(
            -b / 2 + torch.sqrt(torch.clamp_min(disc3, 0.0)) / 2, a), 0.0)
        l_lin = self._safe_div(c_neg, b)
        L_tke = torch.where(branch_quad, l_quad,
                            torch.where(torch.abs(b) > _TOL, l_lin, 0.0))

        def _valid(L):
            return torch.where((L < _TOL) | (L > ml.max_length),
                               ml.max_length, L)

        l_mix = lamb_smooth_minimum(
            torch.stack([_valid(L_N), _valid(L_W), _valid(L_tke)], dim=-1),
            ml.smin_ub, ml.smin_rm)
        return l_mix, dbdz, Pr_t

    def _dpdz(self, model, q, gf, sub, b_up):
        """The perturbation pressure gradient (He et al. 2020)."""
        pr = self.pressure
        rhoa_raw = self._tc(model, q, "up_rhoa")
        w_up = self._safe_div(self._tc(model, q, "up_rhoaw"), rhoa_raw)
        dwdz = model.gf_spec.get(gf, "turbconv.up_dwdz")
        dw = w_up - sub.w_en[:, None]
        return (pr.alpha_b * b_up - pr.alpha_a * w_up * dwdz
                + pr.alpha_d * dw * torch.abs(dw) / pr.H_up_min)

    def _precompute(self, model, q, gf, aux):
        """What the flux and source hooks share."""
        return self._memoized("pc", self._precompute_of, model, q, gf, aux)

    def _precompute_of(self, model, q, gf, aux):
        sub = self._subdomain_thermo(model, q, aux)
        b_up, b_en = self._buoyancy(model, q, aux, sub)
        E_dyn, D_dyn, E_trb = self._entr_detr(model, q, aux, sub, b_up,
                                              b_en)
        gfs = model.gf_spec
        shear2 = (gfs.get(gf, "turbconv.dudz") ** 2
                  + gfs.get(gf, "turbconv.dvdz") ** 2
                  + gfs.get(gf, "turbconv.en_dwdz") ** 2)
        l_mix, dbdz, Pr_t = self._mixing_length(model, q, gf, aux, sub,
                                                D_dyn, E_trb, shear2)
        rho = model.prog_spec.get(q, "rho")
        tke_en = torch.clamp_min(self._tc(model, q, "en_rhoatke"), 0.0) \
            / rho / sub.a_en
        K_m = self.mix_len.c_m * l_mix * torch.sqrt(tke_en)
        Diss0 = self.mix_len.c_d * torch.sqrt(tke_en) \
            / torch.clamp_min(l_mix, _TOL)
        return SimpleNamespace(sub=sub, b_up=b_up, b_en=b_en, E_dyn=E_dyn,
                               D_dyn=D_dyn, E_trb=E_trb, shear2=shear2,
                               l_mix=l_mix, dbdz=dbdz, Pr_t=Pr_t, K_m=K_m,
                               K_h=K_m / Pr_t, Diss0=Diss0,
                               dpdz=self._dpdz(model, q, gf, sub, b_up),
                               tke_en=tke_en)

    # --- the hooks AtmosModel calls ------------------------------------------------
    def init_state(self, model, q, aux):
        """Updrafts of the least area a_min at the grid mean's w and θ_liq,
        an environment TKE ρ max(1 − z/3000, 0) up to 2500 m and small
        covariance seeds; the thermo straight from the state (the aux
        lanes are not filled yet)."""
        ps, sp = model.param_set, model.prog_spec
        rho, rhou = sp.get(q, "rho"), sp.get(q, "rhou")
        w_gm = rhou[:, 2]
        Phi = model.aux_spec.get(aux, "orientation.Phi")
        e_int = td.internal_energy_from_state(rho, sp.get(q, "rhoe"), rhou,
                                              Phi)
        moist = self._moist(model)
        if moist:
            q_tot = sp.get(q, "moisture.rhoq_tot") / rho
            T = td.saturation_adjustment(ps, e_int, rho, q_tot)
            pp = td.phase_partition_equil(ps, T, rho, q_tot)
        else:
            pp = None
            T = td.air_temperature(ps, e_int)
        p = td.air_pressure(ps, T, rho, pp)
        theta_liq = td.liquid_ice_pottemp(ps, T, p, pp)
        z = Phi / ps.grav
        a_min = self.subdomains.a_min
        ones = rho.new_ones((rho.shape[0], self.N_up, rho.shape[1]))
        out = q.clone()
        _put(out, sp, "turbconv.up_rhoa", rho[:, None] * a_min * ones)
        _put(out, sp, "turbconv.up_rhoaw",
             (rho * w_gm)[:, None] * a_min * ones)
        _put(out, sp, "turbconv.up_rhoatheta_liq",
             (rho * theta_liq)[:, None] * a_min * ones)
        _put(out, sp, "turbconv.en_rhoatke",
             torch.where(z <= 2500.0,
                         rho * torch.clamp_min(1 - z / 3000.0, 0), 0.0))
        zc = torch.clamp_min(z, 10.0)
        _put(out, sp, "turbconv.en_rhoatheta_liq_cv", 1e-5 / zc)
        if moist:
            _put(out, sp, "turbconv.up_rhoaq_tot",
                 (rho * q_tot)[:, None] * a_min * ones)
            _put(out, sp, "turbconv.en_rhoaq_tot_cv", 1e-5 / zc)
            _put(out, sp, "turbconv.en_rhoatheta_liq_q_tot_cv", 1e-7 / zc)
        return out

    def update_aux(self, model, q, aux):
        """The subdomain temperatures into ``turbconv.up_T`` and
        ``turbconv.en_T``."""
        sub = self._subdomain_thermo(model, q, aux)
        out = aux.clone()
        _put(out, model.aux_spec, "turbconv.up_T", sub.T_up)
        _put(out, model.aux_spec, "turbconv.en_T", sub.T_en)
        # the subdomain thermo reads no EDMF lane: the refreshed aux gives
        # the same
        self._remember("sub", sub, model, q, out)
        return out

    def flux_first_order(self, model, q, aux, F):
        """The vertical advection of every EDMF lane (its lanes of ``F``
        set in place; returns F)."""
        sp = model.prog_spec
        khat = model.vertical_unit(aux)                      # [E, 3, L]
        a_en, w_en = self._environment(model, q)
        rhoa_c = self._rhoa_up(model, q)
        void = self._tc(model, q, "up_rhoa") <= _TOL
        rhoaw = self._tc(model, q, "up_rhoaw")
        w_up = self._safe_div(rhoaw, rhoa_c)

        def zflux(name, val):                                # val [E, K, L]
            F[:, :, sp.index(f"turbconv.{name}")] = \
                khat[:, :, None] * torch.where(void, 0.0, val)[:, None]

        zflux("up_rhoa", rhoaw)
        zflux("up_rhoaw", rhoaw * w_up)
        zflux("up_rhoatheta_liq",
              w_up * self._tc(model, q, "up_rhoatheta_liq"))
        names = ["en_rhoatke", "en_rhoatheta_liq_cv"]
        if self._moist(model):
            zflux("up_rhoaq_tot", w_up * self._tc(model, q, "up_rhoaq_tot"))
            names += ["en_rhoaq_tot_cv", "en_rhoatheta_liq_q_tot_cv"]
        for nm in names:
            F[:, :, sp.index(f"turbconv.{nm}").start] = \
                khat * (self._tc(model, q, nm) * w_en)[:, None]
        return F

    def gradient_argument(self, model, q, aux, t, out):
        """EDMF's gradient arguments into its lanes of ``out``."""
        ps, gs = model.param_set, model.grad_spec
        sp = model.prog_spec
        rho, rhou = sp.get(q, "rho"), sp.get(q, "rhou")
        sub = self._subdomain_thermo(model, q, aux)
        w_up = self._safe_div(self._tc(model, q, "up_rhoaw"),
                              self._tc(model, q, "up_rhoa"))
        rho_a = sub.a_en * rho
        z = model.aux_spec.get(aux, "orientation.Phi") / ps.grav
        e_kin = 0.5 * ((rhou[:, 0] / rho) ** 2 + (rhou[:, 1] / rho) ** 2
                       + sub.w_en ** 2)
        e_tot_en = td.internal_energy(ps, sub.T_en, sub.pp_en) + e_kin \
            + ps.grav * z
        vals = {
            "up_w": w_up,
            "en_theta_liq": sub.theta_liq_en,
            "en_w": sub.w_en,
            "en_tke": self._tc(model, q, "en_rhoatke") / rho_a,
            "en_theta_liq_cv": self._tc(model, q, "en_rhoatheta_liq_cv")
            / rho_a,
            "en_thetav": td.virtual_pottemp(ps, sub.T_en, sub.p_gm,
                                            sub.pp_en),
            "en_h_tot": td.total_specific_enthalpy(ps, e_tot_en, sub.T_en,
                                                   sub.pp_en),
            "u": rhou[:, 0] / rho,
            "v": rhou[:, 1] / rho}
        if self._moist(model):
            vals.update({
                "en_q_tot": sub.q_tot_en,
                "en_q_tot_cv": self._tc(model, q, "en_rhoaq_tot_cv") / rho_a,
                "en_theta_liq_q_tot_cv": self._tc(
                    model, q, "en_rhoatheta_liq_q_tot_cv") / rho_a})
        out = out.clone()
        for name, val in vals.items():
            _put(out, gs, f"turbconv.{name}", val)
        return out

    def gradient_flux(self, model, grad_g, q, aux, t, out):
        """The vertical derivatives k̂·∇ of EDMF's gradient arguments into
        its gradient-flux lanes of ``out``."""
        k = model.vertical_unit(aux)[:, :, None]             # [E, 3, 1, L]
        gs, fs = model.grad_spec, model.gf_spec
        pairs = [("up_w", "up_dwdz"), ("en_theta_liq", "en_dthetadz"),
                 ("en_w", "en_dwdz"), ("en_tke", "en_dtkedz"),
                 ("en_theta_liq_cv", "en_dtheta_cvdz"),
                 ("en_thetav", "en_dthetavdz"), ("en_h_tot", "en_dhtotdz"),
                 ("u", "dudz"), ("v", "dvdz")]
        if self._moist(model):
            pairs += [("en_q_tot", "en_dqtdz"),
                      ("en_q_tot_cv", "en_dqt_cvdz"),
                      ("en_theta_liq_q_tot_cv", "en_dthqt_cvdz")]
        out = out.clone()
        for g_name, f_name in pairs:
            sl = gs.index(f"turbconv.{g_name}")
            out[:, fs.index(f"turbconv.{f_name}")] = torch.sum(
                grad_g[:, :, sl] * k, dim=1)
        return out

    def flux_second_order(self, model, q, gf, aux, F):
        """The environment's second moments diffused with K_m, K_h and,
        ``Coupled``, the SGS fluxes of the grid mean's ρe, ρu and ρq_tot
        (added to ``F`` in place; returns F)."""
        ps, sp, fs = model.param_set, model.prog_spec, model.gf_spec
        khat = model.vertical_unit(aux)
        pc = self._precompute(model, q, gf, aux)
        sub = pc.sub
        rho = sp.get(q, "rho")
        rho_a_en = rho * sub.a_en

        def add_flux(name, val):                             # val [E, L]
            F[:, :, sp.index(name).start] += khat * val[:, None]

        grad = lambda name: fs.get(gf, f"turbconv.{name}")
        add_flux("turbconv.en_rhoatke",
                 -rho_a_en * pc.K_m * grad("en_dtkedz"))
        add_flux("turbconv.en_rhoatheta_liq_cv",
                 -rho_a_en * pc.K_h * grad("en_dtheta_cvdz"))
        moist = self._moist(model)
        if moist:
            add_flux("turbconv.en_rhoaq_tot_cv",
                     -rho_a_en * pc.K_h * grad("en_dqt_cvdz"))
            add_flux("turbconv.en_rhoatheta_liq_q_tot_cv",
                     -rho_a_en * pc.K_h * grad("en_dthqt_cvdz"))
        if not isinstance(self.coupling, Coupled):
            return F

        # the SGS fluxes of the grid mean
        rhou = sp.get(q, "rhou")
        u, v = rhou[:, 0] / rho, rhou[:, 1] / rho
        w_gm = rhou[:, 2] / rho
        rhoa_c = self._rhoa_up(model, q)
        void = self._tc(model, q, "up_rhoa") <= _TOL
        w_up = self._safe_div(self._tc(model, q, "up_rhoaw"), rhoa_c)
        gz = ps.grav * (model.aux_spec.get(aux, "orientation.Phi")
                        / ps.grav)

        e_kin_up = 0.5 * (u[:, None] ** 2 + v[:, None] ** 2 + w_up ** 2)
        e_tot_up = td.internal_energy(ps, sub.T_up, sub.pp_up) + e_kin_up \
            + gz[:, None]
        h_up = td.total_specific_enthalpy(ps, e_tot_up, sub.T_up, sub.pp_up)
        e_kin_en = 0.5 * (u ** 2 + v ** 2 + sub.w_en ** 2)
        e_tot_en = td.internal_energy(ps, sub.T_en, sub.pp_en) + e_kin_en \
            + gz
        h_en = td.total_specific_enthalpy(ps, e_tot_en, sub.T_en, sub.pp_en)
        h_gm = td.total_specific_enthalpy(ps, sp.get(q, "rhoe") / rho,
                                          sub.T_gm, sub.pp_gm)
        dw_up = w_gm[:, None] - w_up
        dw_en = w_gm - sub.w_en

        def mass_flux(phi_gm, phi_up, phi_en, dw_u, dw_e):
            return torch.sum(torch.where(void, 0.0, rhoa_c * (
                phi_gm[:, None] - phi_up) * dw_u), dim=1) \
                + rho * sub.a_en * (phi_gm - phi_en) * dw_e

        f_e = -rho * sub.a_en * pc.K_h * grad("en_dhtotdz") \
            + mass_flux(h_gm, h_up, h_en, dw_up, dw_en)
        add_flux("rhoe", f_e)

        mf_w = torch.sum(torch.where(void, 0.0, rhoa_c * dw_up ** 2), dim=1) \
            + rho * sub.a_en * dw_en ** 2
        f_u = -rho * sub.a_en * pc.K_m * grad("dudz")
        f_v = -rho * sub.a_en * pc.K_m * grad("dvdz")
        f_w = -rho * sub.a_en * pc.K_m * grad("en_dwdz") + mf_w
        F[:, :, sp.index("rhou")] += khat[:, :, None] * torch.stack(
            [f_u, f_v, f_w], dim=1)[:, None]

        if moist:
            q_gm = sp.get(q, "moisture.rhoq_tot") / rho
            q_up = self._safe_div(self._tc(model, q, "up_rhoaq_tot"), rhoa_c)
            f_q = -rho * sub.a_en * pc.K_h * grad("en_dqtdz") \
                + mass_flux(q_gm, q_up, sub.q_tot_en, dw_up, dw_en)
            add_flux("moisture.rhoq_tot", f_q)
        return F

    def source(self, model, q, gf, aux, t):
        """Every EDMF source (entrainment and detrainment, the
        perturbation pressure, buoyancy, shear production, dissipation
        and gradient production), ``[E, n, L]``."""
        sp = model.prog_spec
        out = torch.zeros_like(q)
        pc = self._precompute(model, q, gf, aux)
        sub = pc.sub
        rho = sp.get(q, "rho")
        rhoa_raw = self._tc(model, q, "up_rhoa")
        void = rhoa_raw <= _TOL
        up = lambda name: self._safe_div(self._tc(model, q, name), rhoa_raw)
        w_up, th_up = up("up_rhoaw"), up("up_rhoatheta_liq")
        E, D, Et = pc.E_dyn, pc.D_dyn, pc.E_trb
        w_en = sub.w_en
        w_gm = sp.get(q, "rhou")[:, 2] / rho
        tke_sp = pc.tke_en
        mask = lambda x: torch.where(void, 0.0, x)
        entrain = lambda en, upd: mask((E + Et) * en[:, None]
                                       - (D + Et) * upd)

        # the updrafts
        _put(out, sp, "turbconv.up_rhoa", mask(E - D))
        _put(out, sp, "turbconv.up_rhoaw",
             entrain(w_en, w_up) + rhoa_raw * (pc.b_up - pc.dpdz))
        _put(out, sp, "turbconv.up_rhoatheta_liq",
             entrain(sub.theta_liq_en, th_up))
        moist = self._moist(model)
        if moist:
            qt_up = up("up_rhoaq_tot")
            _put(out, sp, "turbconv.up_rhoaq_tot",
                 entrain(sub.q_tot_en, qt_up))

        # the environment's TKE
        dw = w_up - w_en[:, None]
        ed_tke = torch.sum(mask(Et * (w_en - w_gm)[:, None] * (-dw)
                                - (E + Et) * tke_sp[:, None]
                                + D * dw * dw / 2), dim=1)
        rhoa_c = self._rhoa_up(model, q)
        press_tke = torch.sum(mask(rhoa_c * dw * pc.dpdz), dim=1)
        rho_a_en = rho * sub.a_en
        shear_tke = rho_a_en * pc.K_m * pc.shear2
        buoy_tke = -rho_a_en * pc.K_h * pc.dbdz
        diss_tke = -pc.Diss0 * self._tc(model, q, "en_rhoatke")
        _put(out, sp, "turbconv.en_rhoatke",
             ed_tke + press_tke + shear_tke + buoy_tke + diss_tke)

        # the covariances
        fs = model.gf_spec
        th_gm, th_en = sub.theta_liq_gm, sub.theta_liq_en
        dthdz = fs.get(gf, "turbconv.en_dthetadz")

        def covariance(name, x_up, x_en, x_gm, y_up, y_en, y_gm, dxdz, dydz):
            """ρa⟨x'y'⟩'s source: entrainment and detrainment, less the
            dissipation, plus the gradient production."""
            rhocv = self._tc(model, q, name)
            ed = torch.sum(mask(
                D * (x_up - x_en[:, None]) * (y_up - y_en[:, None])
                + Et * (x_en - x_gm)[:, None] * (y_en[:, None] - y_up)
                + Et * (y_en - y_gm)[:, None] * (x_en[:, None] - x_up)
                - (E + Et) * rhocv[:, None]), dim=1)
            _put(out, sp, f"turbconv.{name}",
                 ed - pc.Diss0 * rhocv + rho_a_en * 2 * pc.K_h * dxdz * dydz)

        def variance(name, x_up, x_en, x_gm, dxdz):
            rhocv = self._tc(model, q, name)
            ed = torch.sum(mask(
                D * (x_up - x_en[:, None]) ** 2
                + 2 * Et * (x_en - x_gm)[:, None] * (x_en[:, None] - x_up)
                - (E + Et) * rhocv[:, None]), dim=1)
            _put(out, sp, f"turbconv.{name}",
                 ed - pc.Diss0 * rhocv + rho_a_en * 2 * pc.K_h * dxdz * dxdz)

        variance("en_rhoatheta_liq_cv", th_up, th_en, th_gm, dthdz)
        if moist:
            qt_en, qt_gm = sub.q_tot_en, sub.q_tot_gm
            dqtdz = fs.get(gf, "turbconv.en_dqtdz")
            variance("en_rhoaq_tot_cv", qt_up, qt_en, qt_gm, dqtdz)
            covariance("en_rhoatheta_liq_q_tot_cv", th_up, th_en, th_gm,
                       qt_up, qt_en, qt_gm, dthdz, dqtdz)
        return out

    # --- the walls -------------------------------------------------------------
    def surface_values(self, model, qM, auxM):
        """The updrafts' and the environment's values at the surface."""
        ps, sf = model.param_set, self.surface
        T, p, _, pp = model.thermo_full(qM, auxM)
        theta_liq = td.liquid_ice_pottemp(ps, T, p, pp)
        th_flux = sf.shf / td.exner(ps, p, pp) / td.cp_m(ps, pp)
        q_flux = sf.lhf / td.latent_heat_vapor(ps, T)
        ol, ustar = sf.obukhov_length, sf.ustar
        if ol < -_TOL:
            fact = (1.0 - sf.psi_phi_stab * sf.zLL / ol) ** (-2.0 / 3.0)
            tke_fact = math.cbrt((sf.zLL / ol) ** 2)
        else:
            fact, tke_fact = 1.0, 0.0
        us2 = ustar ** 2
        th_cv = 4 * th_flux * th_flux / us2 * fact
        std = qM.new_tensor(self.upd_surface_std)[None, :, None]
        th_up = theta_liq[:, None] + std * torch.sqrt(
            torch.clamp_min(th_cv, 0.0))[:, None]
        q_cv = 4 * q_flux * q_flux / us2 * fact
        q_up = None
        if self._moist(model):
            sp = model.prog_spec
            q_tot = sp.get(qM, "moisture.rhoq_tot") / sp.get(qM, "rho")
            q_up = q_tot[:, None] + std * torch.sqrt(
                torch.clamp_min(q_cv, 0.0))[:, None]
        return SimpleNamespace(a_up=sf.a / self.N_up, th_up=th_up, q_up=q_up,
                               th_cv=th_cv, q_cv=q_cv,
                               thq_cv=4 * th_flux * q_flux / us2 * fact,
                               tke=us2 * (sf.kappa_star2 + tke_fact))

    def boundary_state(self, model, tag, qM, auxM, qP):
        """The wall ghost ``qP`` with EDMF's lanes: at the bottom (tag 1)
        the surface values, at the top (tag 2) ρaw = 0."""
        sp = model.prog_spec
        rho = sp.get(qM, "rho")
        out = qP.clone()
        zeros = rho.new_zeros((rho.shape[0], self.N_up, rho.shape[1]))
        _put(out, sp, "turbconv.up_rhoaw", zeros)
        if tag != 1:
            return out
        sv = self.surface_values(model, qM, auxM)
        a_en = 1.0 - self.surface.a
        _put(out, sp, "turbconv.up_rhoa", (rho * sv.a_up)[:, None] + zeros)
        _put(out, sp, "turbconv.up_rhoatheta_liq",
             rho[:, None] * sv.a_up * sv.th_up)
        _put(out, sp, "turbconv.en_rhoatke", rho * a_en * sv.tke)
        _put(out, sp, "turbconv.en_rhoatheta_liq_cv", rho * a_en * sv.th_cv)
        if self._moist(model):
            _put(out, sp, "turbconv.up_rhoaq_tot",
                 rho[:, None] * sv.a_up * sv.q_up)
            _put(out, sp, "turbconv.en_rhoaq_tot_cv", rho * a_en * sv.q_cv)
            _put(out, sp, "turbconv.en_rhoatheta_liq_q_tot_cv",
                 rho * a_en * sv.thq_cv)
        return out

    def filter_variables(self, model) -> Tuple[str, ...]:
        """The prognostic names TMAR keeps positive."""
        names = ["turbconv.up_rhoa", "turbconv.up_rhoaw",
                 "turbconv.up_rhoatheta_liq", "turbconv.en_rhoatke",
                 "turbconv.en_rhoatheta_liq_cv"]
        if self._moist(model):
            names += ["turbconv.up_rhoaq_tot", "turbconv.en_rhoaq_tot_cv"]
        return tuple(names)
