"""The split-explicit barotropic/baroclinic ocean (port of
``climatemachine_tpu/ocean/split_explicit.py``: ``CoupledHBModel`` :35,
``BarotropicModel`` :158, ``SplitExplicitSolver`` :183 with ``step``
:236 in its "new" variant).

Per slow LSRK2N stage: the 3-D baroclinic tendency is evaluated, its
column integral forces the 2-D barotropic model (Gᵁ), the vertical mean
is taken out of the 3-D tendency (ΔGᵘ = −Gᵁ/H), the fast model substeps
the stage interval, and its end state (U, η) replaces the barotropic
content of the 3-D state (u += (U − ∫u dz)/H, η copied down every
column).  The couplings are the column layouts of dg/columns.py: the
2-D grid is the brick on the 3-D grid's horizontal ranges, whose
elements and nodes are the stacked brick's horizontal ones.  Plain
PyTorch, as the JAX package leaves it to XLA: the ocean's operators take
no kernel.

The "split01" and "split01_3n" variants (multi-rate averaging windows,
the 3N slow recurrence, IVDC inside the step) are not ported yet.
"""

from __future__ import annotations

import torch

from climatemachine_tpu_torch.dg.columns import ColumnOps
from climatemachine_tpu_torch.ocean import core as oc
from climatemachine_tpu_torch.ocean.hydrostatic_boussinesq import \
    HydrostaticBoussinesqModel
from climatemachine_tpu_torch.ocean.shallow_water import ShallowWaterModel
from climatemachine_tpu_torch.utils.variables import VarSpec


class CoupledHBModel(HydrostaticBoussinesqModel):
    """The baroclinic side: no gη flux (the fast model carries it), pkin
    stores g·∫_z^0 −αᵀθ and is the flux itself, Coriolis acts on the flow
    deviation uᵈ = u − ∫u dz / H, the source adds ΔGᵘ, and the
    horizontal viscous rows act on uᵈ.  ``num_impl_steps`` IVDC solves
    at ``ivdc_dt`` follow each slow step (experiments/
    ocean_split_explicit.py runs them); with them on, the explicit
    vertical diffusivity is κᶻ/2 without the convective branch."""

    def __init__(self, *args, num_impl_steps: int = 0, ivdc_dt: float = 0.0,
                 **kw):
        kw.setdefault("coupling", oc.Coupled())
        super().__init__(*args, **kw)
        self.grad_spec = VarSpec(u=2, ud=2, theta=1)
        self.num_impl_steps = int(num_impl_steps)
        self.ivdc_dt = float(ivdc_dt)

    def update_auxiliary_state(self, q, aux, grid):
        """uᵈ = u − ∫u dz / H, every RHS."""
        u = self.prog(q, "u")
        aux = aux.clone()
        aux[:, self.aux_spec.index("ud")] = (
            u - self._cols(grid).column_total(u) / self.problem.H)
        return aux

    def update_auxiliary_state_gradient(self, dg, gf, q, aux, t):
        """w = ∫_b^z −∇ʰ·u, pkin = ∫_z^0 −g αᵀθ and wz0 = w(z = 0)."""
        cols = self._cols(dg.grid)
        w = cols.indefinite_integral(-self.gf_spec.get(gf, "div_h_u")[:,
                                                                       None])
        theta = self.prog(q, "theta")
        pkin = cols.reverse_indefinite_integral(
            (-self.param_set.grav * self.alpha_T * theta)[:, None])
        sp = self.aux_spec
        aux = aux.clone()
        aux[:, sp.index("w")] = w
        aux[:, sp.index("pkin")] = pkin
        aux[:, sp.index("wz0")] = cols.broadcast_top(w)
        return aux, q

    def flux_first_order(self, q, aux, t):
        """pkin Iʰ on u, with "nonlinear" advection v⊗u on u and vθ on
        θ."""
        s = self.prog_spec
        iu, ith = s.index("u"), s.index("theta").start
        E, n, L = q.shape
        F = q.new_zeros((E, 3, n, L))
        pkin = self.aux_get(aux, "pkin")
        F[:, 0, iu.start] = pkin
        F[:, 1, iu.start + 1] = pkin
        if self.momentum_advection == "nonlinear" \
                or self.tracer_advection == "nonlinear":
            v = self._velocity3(q, aux)
        if self.momentum_advection == "nonlinear":
            F[:, :, iu] = F[:, :, iu] + v[:, :, None] * self.prog(
                q, "u")[:, None]
        if self.tracer_advection == "nonlinear":
            F[:, :, ith] = v * self.prog(q, "theta")[:, None]
        return F

    def boundary_state(self, tag, nrm, q_minus, aux_minus, t):
        """The uncoupled ghost; a no-slip wall also reflects uᵈ for the
        gradient pass."""
        qP, auxP = super().boundary_state(tag, nrm, q_minus, aux_minus, t)
        bc = self.problem.boundary_conditions[tag - 1]
        if isinstance(bc.velocity, oc.Impenetrable) \
                and isinstance(bc.velocity.drag, oc.NoSlip):
            iud = self.aux_spec.index("ud")
            auxP[:, iud] = -aux_minus[:, iud]
        return qP, auxP

    def source(self, q, aux, t, gf=None):
        """η: w(z = 0); u: −f×uᵈ + ΔGᵘ."""
        s = self.prog_spec
        iu = s.index("u").start
        out = torch.zeros_like(q)
        out[:, s.index("eta").start] = self.aux_get(aux, "wz0")
        ud = self.aux_get(aux, "ud")
        dGu = self.aux_get(aux, "dGu")
        f = self.coriolis_parameter(self.aux_get(aux, "y"))
        out[:, iu] = f * ud[:, 1] + dGu[:, 0]
        out[:, iu + 1] = -f * ud[:, 0] + dGu[:, 1]
        return out

    def compute_gradient_argument(self, q, aux, t):
        return torch.cat([self.prog(q, "u"), self.aux_get(aux, "ud"),
                          q[:, self.prog_spec.index("theta")]], dim=1)

    def compute_gradient_flux(self, grad_g, q, aux, t):
        """∇ʰ·u; −ν∇u with the horizontal rows from ∇uᵈ; −κ∇θ."""
        gs = self.grad_spec
        grad_u = grad_g[:, :, gs.index("u")]                 # [E, 3, 2, L]
        grad_ud = grad_g[:, :, gs.index("ud")]
        grad_th = grad_g[:, :, gs.index("theta").start]      # [E, 3, L]
        div_h_u = grad_u[:, 0, 0] + grad_u[:, 1, 1]
        mixed = torch.cat([grad_ud[:, :2], grad_u[:, 2:]], dim=1)
        nu = grad_g.new_tensor([self.nu_h, self.nu_h, self.nu_z])
        nu_grad_u = -nu[None, :, None, None] * mixed
        dz = grad_th[:, 2]
        if self.num_impl_steps > 0:
            kz = torch.full_like(dz, 0.5 * self.kappa_z)
        else:
            kz = torch.where(dz < 0, torch.full_like(dz, self.kappa_c),
                             torch.full_like(dz, self.kappa_z))
        kh = torch.full_like(dz, self.kappa_h)
        kap = torch.stack([kh, kh, kz], dim=1)
        E, L = q.shape[0], q.shape[-1]
        return torch.cat([div_h_u[:, None], nu_grad_u.reshape(E, 6, L),
                          -kap * grad_th], dim=1)


class BarotropicModel(ShallowWaterModel):
    """The fast side: its forcing is Gᵁ (no stress, no drag); aux also
    carries the split01 variants' accumulators U_c, η_c, the mid-window
    save U_s, η_s and the η diagnostics η_diag, Δη."""

    def __init__(self, problem, **kw):
        kw.setdefault("coupling", oc.Coupled())
        super().__init__(problem, **kw)
        self.aux_spec = VarSpec(coord=2, y=1, GU=2, du=2,
                                U_c=2, eta_c=1, U_s=2, eta_s=1,
                                eta_diag=1, deta=1)

    def source(self, q, aux, t, gf=None):
        """U: −f×U + Gᵁ."""
        out = torch.zeros_like(q)
        out[:, self.prog_spec.index("U")] = (self._coriolis(q, aux)
                                             + self.aux_get(aux, "GU"))
        return out


VARIANTS = ("new", "split01", "split01_3n")


class SplitExplicitSolver:
    """The slow LSRK2N over the 3-D model with fast substepping of the
    2-D model.  State and aux are the pairs (q3, q2), (aux3, aux2).
    Each stage substeps its interval at ``fast_dt`` rounded to divide
    it, and the fast end state reconciles the slow one.  ``coupled=False``
    runs the same stage loop (two slow RHS per stage, so the filters run
    twice) without the transfers.  ``variant`` "split01" and
    "split01_3n" raise "next slice"."""

    def __init__(self, slow_solver, fast_solver, dg3, dg2, dt=None,
                 fast_dt=None, coupled=True, variant="new"):
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got "
                             f"{variant!r}")
        if variant != "new":
            from climatemachine_tpu_torch.ocean import NEXT_SLICE
            raise NotImplementedError(f"next slice: {NEXT_SLICE[variant]}")
        self.slow, self.fast = slow_solver, fast_solver
        self.dg3, self.dg2 = dg3, dg2
        self.dt = float(dt if dt is not None else slow_solver.dt)
        self.fast_dt = float(fast_dt if fast_dt is not None
                             else fast_solver.dt)
        self.coupled = coupled
        self.variant = variant
        self.cols = ColumnOps(dg3.grid)
        self.H = dg3.balance_law.problem.H
        self.nstages = slow_solver.nstages
        self.dt_fixed = True

    def fast_steps(self):
        """The number of fast steps of each slow stage."""
        C, dt = self.slow.C, self.dt
        out = []
        for s in range(self.nstages):
            gamma = (1.0 - C[s]) if s == self.nstages - 1 else C[s + 1] - C[s]
            out.append(max(int(-(-(gamma * dt) // self.fast_dt)), 1))
        return out

    def _slow_rhs(self, q3, aux3, t):
        """The 3-D RHS after ``pre_stage``: (q3 filtered, dq3/dt,
        aux3)."""
        q3 = self.dg3.pre_stage(q3, aux3, t)
        tend3, aux3 = self.dg3(q3, aux3, t)
        return q3, tend3, aux3

    def _transfer(self, tend3, aux3, aux2):
        """Gᵁ = ∫ ∂u/∂t dz to the 2-D aux and ΔGᵘ = −Gᵁ/H to the 3-D one:
        (aux3, aux2)."""
        m3, m2 = self.dg3.balance_law, self.dg2.balance_law
        int_du = self.cols.column_total_2d(tend3[:, m3.prog_spec.index("u")])
        aux2 = aux2.clone()
        aux2[:, m2.aux_spec.index("GU")] = int_du
        aux3 = aux3.clone()
        aux3[:, m3.aux_spec.index("dGu")] = (-self.cols.broadcast_2d(int_du)
                                             / self.H)
        return aux3, aux2

    def _fast(self, q2, aux2, t, steps: int, fast_dt: float):
        """``steps`` fast steps of ``fast_dt`` from t: (q2, aux2)."""
        self.fast.dt = fast_dt
        for _ in range(steps):
            q2, aux2 = self.fast.step(q2, aux2, t)
            t += fast_dt
        return q2, aux2

    def _reconcile(self, q3, q2, aux2):
        """u += Δu = (U − ∫u dz)/H down each column and η copied down:
        (q3, aux2)."""
        m3, m2 = self.dg3.balance_law, self.dg2.balance_law
        u_sl = m3.prog_spec.index("u")
        du = (m2.prog(q2, "U")
              - self.cols.column_total_2d(q3[:, u_sl])) / self.H
        aux2 = aux2.clone()
        aux2[:, m2.aux_spec.index("du")] = du
        q3 = q3.clone()
        q3[:, u_sl] += self.cols.broadcast_2d(du)
        q3[:, m3.prog_spec.index("eta")] = self.cols.broadcast_2d(
            q2[:, m2.prog_spec.index("eta")])
        return q3, aux2

    def step(self, q, aux, t):
        """One slow step from ((q3, q2), (aux3, aux2)) at time t."""
        q3, q2 = q
        aux3, aux2 = aux
        slow, dt = self.slow, self.dt
        i_dGu = self.dg3.balance_law.aux_spec.index("dGu")
        dq3 = None
        for s, steps in enumerate(self.fast_steps()):
            t_stage = t + slow.C[s] * dt
            gamma = (1.0 - slow.C[s]) if s == self.nstages - 1 else \
                (slow.C[s + 1] - slow.C[s])
            if self.coupled:
                aux3 = aux3.clone()
                aux3[:, i_dGu] = 0.0
                # the transfer: the slow tendency without accumulation;
                # the RHS filters q first, as the reference's does
                q3, tend3, aux3 = self._slow_rhs(q3, aux3, t_stage)
                aux3, aux2 = self._transfer(tend3, aux3, aux2)
            else:
                # the reference evaluates the slow RHS here too; only its
                # filter of q survives without the coupling
                q3 = self.dg3.pre_stage(q3, aux3, t_stage)
            # the slow tendency with ΔGᵘ; filtering again is part of the
            # trajectory (the exponential θ filter is not idempotent)
            q3, tend3, aux3 = self._slow_rhs(q3, aux3, t_stage)
            dq3 = tend3 if dq3 is None else slow.A[s] * dq3 + tend3
            q2, aux2 = self._fast(q2, aux2, t_stage, steps,
                                  gamma * dt / steps)
            q3 = q3 + (slow.B[s] * dt) * dq3
            if self.coupled:
                q3, aux2 = self._reconcile(q3, q2, aux2)
        return (q3, q2), (aux3, aux2)
