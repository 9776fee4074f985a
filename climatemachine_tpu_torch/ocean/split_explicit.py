"""The split-explicit barotropic/baroclinic ocean (port of
``climatemachine_tpu/ocean/split_explicit.py``: ``CoupledHBModel`` :35,
``BarotropicModel`` :158, ``SplitExplicitSolver`` :183 with ``step``
:236 in its three variants, ``_step_split01_3n`` :385 and
``_col_top_2d`` :522).

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

The "split01" variant (reference SplitExplicit01) widens each stage's
fast window by ``add_fast_substeps``, averages the fast state over the
window's end into U_c, η_c (the reconcile's barotropic content), saves
the fast state at the window's middle into U_s, η_s, restarts the next
stage from that save, copies η down and diagnoses η_diag and Δη at the
last stage only, and runs the 3-D model's ``num_impl_steps`` IVDC solves
inside the step.  "split01_3n" walks the 3N slow recurrence
(LS3NRK33Heuns3N) with its fast windows on the LCM-12 grid of the RK
coefficients.  The averaging counts stay Python floats: the host reads
nothing back from the card inside a step.
"""

from __future__ import annotations

import math

import torch
from torch.profiler import record_function

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
    at ``ivdc_dt`` follow each slow step (inside the split01 variants'
    step; after the "new" one's in experiments/ocean_split_explicit.py);
    with them on, the explicit vertical diffusivity is κᶻ/2 without the
    convective branch.  ``add_fast_substeps`` is the split01 variants'
    averaging ratio."""

    def __init__(self, *args, num_impl_steps: int = 0, ivdc_dt: float = 0.0,
                 add_fast_substeps: int = 0, **kw):
        kw.setdefault("coupling", oc.Coupled())
        super().__init__(*args, **kw)
        self.grad_spec = VarSpec(u=2, ud=2, theta=1)
        self.num_impl_steps = int(num_impl_steps)
        self.ivdc_dt = float(ivdc_dt)
        self.add_fast_substeps = int(add_fast_substeps)

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
    """The slow method over the 3-D model with fast substepping of the
    2-D model.  State and aux are the pairs (q3, q2), (aux3, aux2).
    ``coupled=False`` runs the same stage loop (two slow RHS per stage, so
    the filters run twice) without the transfers.

    - ``variant="new"``: the slow LSRK2N; each stage substeps its
      interval at ``fast_dt`` rounded to divide it, and the fast end state
      reconciles the slow one, η copied down every stage.  No IVDC inside
      the step.
    - ``variant="split01"``: the slow LSRK2N with the averaging window of
      the 3-D model's ``add_fast_substeps`` (:meth:`windows`), the
      reconcile from the window average, η copied and Δη diagnosed at the
      last stage, then the 3-D model's ``num_impl_steps`` IVDC solves.
    - ``variant="split01_3n"``: the same on the 3N recurrence of a
      :class:`~climatemachine_tpu_torch.ode.lsrk3n.LowStorageRungeKutta3N`
      slow solver, whose RKA, RKB, RKC and RKW schedule the windows on
      the LCM-12 fast grid.

    :meth:`step` is :meth:`explicit_step` then :meth:`implicit_step`;
    the split01 variants keep the last step's GMRES residuals (0-d
    tensors on the device) in ``ivdc_residuals``."""

    def __init__(self, slow_solver, fast_solver, dg3, dg2, dt=None,
                 fast_dt=None, coupled=True, variant="new"):
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got "
                             f"{variant!r}")
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
        self.ivdc_residuals = []

    # --- the fast windows ---------------------------------------------------
    def _add(self) -> int:
        return getattr(self.dg3.balance_law, "add_fast_substeps", 0)

    def windows(self):
        """Each slow stage's fast window: (k_lo, k_save, k_hi, fast_dt,
        t0f).  The stage runs k_hi fast steps of fast_dt; the split01
        variants average the fast state over steps k_lo..k_hi and save it
        after step k_save (0: no save); split01_3n's fast steps start at
        t + t0f, the others' at the stage's time.  The substep counts come
        from the input ``fast_dt`` at every stage, with the JAX package's
        floor divisions in its order."""
        if self.variant == "split01_3n":
            return self._windows_3n()
        C, dt, add = self.slow.C, self.dt, self._add()
        out = []
        for s in range(self.nstages):
            gamma = (1.0 - C[s]) if s == self.nstages - 1 else \
                (C[s + 1] - C[s])
            fract_dt = gamma * dt
            fast_dt = self.fast_dt
            if add == 0 or self.variant != "split01":
                steps = max(int(-(-fract_dt // fast_dt)), 1)
                k_lo = k_save = k_hi = steps
            else:
                steps = max(int(-(-fract_dt // fast_dt // add)), 1)
                k_save = add * steps
                k_lo = (add - 1) * steps
                k_hi = (add + 1) * steps
            out.append((k_lo, k_save, k_hi, fract_dt / k_save, 0.0))
        return out

    def _windows_3n(self):
        slow, dt, add = self.slow, self.dt, self._add()
        rkC, rkW = slow.RKC, slow.RKW
        steps0 = max(math.ceil(dt / self.fast_dt / 12.0), 1)
        ntsFull = 12 * steps0
        fast_dt_full = dt / ntsFull
        add_steps = (ntsFull // add) if add > 0 else 0
        out = []
        for s in range(self.nstages):
            if s == self.nstages - 1:
                t0f = rkW[0] * dt
                fract = 1.0 - rkW[0]
                save_flag = 1
            else:
                t0f = 0.0
                fract = float(rkC[s + 1])
                save_flag = 0
            steps = max(math.ceil(fract * dt / fast_dt_full), 1)
            addc = min(add_steps, steps - 1)
            k_save = save_flag * steps
            if s == 0:
                k_save = int(round(ntsFull * rkW[0]))
            out.append((steps - addc, k_save, steps + addc,
                        fract * dt / steps, float(t0f)))
        return out

    def fast_steps(self):
        """The number of fast steps of each slow stage."""
        return [w[2] for w in self.windows()]

    # --- the couplings ------------------------------------------------------
    def _slow_rhs(self, q3, aux3, t):
        """The 3-D RHS after ``pre_stage``: (q3 filtered, dq3/dt,
        aux3)."""
        q3 = self.dg3.pre_stage(q3, aux3, t)
        tend3, aux3 = self.dg3(q3, aux3, t)
        return q3, tend3, aux3

    def _transfer(self, q3, aux3, aux2, t):
        """ΔGᵘ = 0, the slow tendency without accumulation (the RHS
        filters q first, as the reference's does), then Gᵁ = ∫ ∂u/∂t dz to
        the 2-D aux and ΔGᵘ = −Gᵁ/H to the 3-D one: (q3, aux3, aux2)."""
        m3, m2 = self.dg3.balance_law, self.dg2.balance_law
        aux3 = aux3.clone()
        aux3[:, m3.aux_spec.index("dGu")] = 0.0
        q3, tend3, aux3 = self._slow_rhs(q3, aux3, t)
        int_du = self.cols.column_total_2d(tend3[:, m3.prog_spec.index("u")])
        aux2 = aux2.clone()
        aux2[:, m2.aux_spec.index("GU")] = int_du
        aux3 = aux3.clone()
        aux3[:, m3.aux_spec.index("dGu")] = (-self.cols.broadcast_2d(int_du)
                                             / self.H)
        return q3, aux3, aux2

    def _fast(self, q2, aux2, t, steps: int, fast_dt: float):
        """``steps`` fast steps of ``fast_dt`` from t: (q2, aux2)."""
        self.fast.dt = fast_dt
        for _ in range(steps):
            q2, aux2 = self.fast.step(q2, aux2, t)
            t += fast_dt
        return q2, aux2

    def _fast_window(self, q2, aux2, t_of, window):
        """The split01 variants' fast window: k_hi fast steps, the n-th
        at time ``t_of(n)``; U_c, η_c zeroed, then summed over steps k_lo..
        k_hi and divided by their count (a Python float), U_s, η_s saved
        after step k_save: (q2, aux2)."""
        m2 = self.dg2.balance_law
        k_lo, k_save, k_hi, fast_dt, _ = window
        iU, ie = m2.prog_spec.index("U"), m2.prog_spec.index("eta")
        sp = m2.aux_spec
        iUc, iec = sp.index("U_c"), sp.index("eta_c")
        aux2 = aux2.clone()
        aux2[:, iUc] = 0.0
        aux2[:, iec] = 0.0
        self.fast.dt = fast_dt
        count = 0.0
        for sub in range(1, k_hi + 1):
            # the 2-D RHS passes aux through, so the copy made above
            # takes the sums in place
            q2, aux2 = self.fast.step(q2, aux2, t_of(sub))
            if sub >= k_lo:
                aux2[:, iUc] = aux2[:, iUc] + q2[:, iU]
                aux2[:, iec] = aux2[:, iec] + q2[:, ie]
                count += 1.0
            if sub == k_save:
                aux2[:, sp.index("U_s")] = q2[:, iU]
                aux2[:, sp.index("eta_s")] = q2[:, ie]
        aux2[:, iUc] = aux2[:, iUc] / count
        aux2[:, iec] = aux2[:, iec] / count
        return q2, aux2

    def _correct_u(self, q3, aux2, U):
        """u += Δu = (U − ∫u dz)/H down each column, Δu to the 2-D aux:
        (q3, aux2)."""
        m3, m2 = self.dg3.balance_law, self.dg2.balance_law
        u_sl = m3.prog_spec.index("u")
        du = (U - self.cols.column_total_2d(q3[:, u_sl])) / self.H
        aux2 = aux2.clone()
        aux2[:, m2.aux_spec.index("du")] = du
        q3 = q3.clone()
        q3[:, u_sl] += self.cols.broadcast_2d(du)
        return q3, aux2

    def _reconcile(self, q3, q2, aux2):
        """The "new" variant: the fast end state's U corrects u and its η
        is copied down: (q3, aux2)."""
        m3, m2 = self.dg3.balance_law, self.dg2.balance_law
        q3, aux2 = self._correct_u(q3, aux2, m2.prog(q2, "U"))
        q3[:, m3.prog_spec.index("eta")] = self.cols.broadcast_2d(
            q2[:, m2.prog_spec.index("eta")])
        return q3, aux2

    def _col_top_2d(self, f3):
        """The column-top nodal values of f3 ``[E, n, Np]`` in the 2-D
        layout ``[Eh, n, Nq₂·Nq₁]``."""
        return self.cols.to_stack(f3)[:, -1, :, -1].clone()

    def _reconcile_split01(self, q3, q2, aux2, last: bool):
        """The split01 variants: the window average U_c corrects u; at the
        last stage η_diag = η at the top, Δη = η_c − η_diag, η_c copied
        down, and the fast state reset to the save: (q3, q2, aux2)."""
        m3, m2 = self.dg3.balance_law, self.dg2.balance_law
        sp = m2.aux_spec
        eta_c = aux2[:, sp.index("eta_c")]
        q3, aux2 = self._correct_u(q3, aux2, aux2[:, sp.index("U_c")])
        if last:
            ie3 = m3.prog_spec.index("eta")
            top = self._col_top_2d(q3[:, ie3])
            aux2[:, sp.index("eta_diag")] = top
            aux2[:, sp.index("deta")] = eta_c - top
            q3[:, ie3] = self.cols.broadcast_2d(eta_c)
            q2 = self._from_save(q2, aux2)
        return q3, q2, aux2

    def _from_save(self, q2, aux2):
        """q2 with (U, η) from the mid-window save (U_s, η_s)."""
        m2 = self.dg2.balance_law
        q2 = q2.clone()
        q2[:, m2.prog_spec.index("U")] = aux2[:, m2.aux_spec.index("U_s")]
        q2[:, m2.prog_spec.index("eta")] = aux2[:, m2.aux_spec.index(
            "eta_s")]
        return q2

    # --- the steps ----------------------------------------------------------
    def step(self, q, aux, t):
        """One slow step from ((q3, q2), (aux3, aux2)) at time t, with the
        split01 variants' IVDC solves."""
        q, aux = self.explicit_step(q, aux, t)
        if self.variant == "new":
            return q, aux
        q3, self.ivdc_residuals = self.implicit_step(q[0], aux[0])
        return (q3, q[1]), aux

    def implicit_step(self, q3, aux3):
        """The 3-D model's ``num_impl_steps`` IVDC solves at its
        ``ivdc_dt`` (none without), each in a profiler span ``ivdc``:
        (q3, [each solve's ‖b − Lx‖/‖b‖, a 0-d tensor])."""
        from climatemachine_tpu_torch.ocean.ivdc import ivdc_solve
        m3 = self.dg3.balance_law
        res = []
        for _ in range(getattr(m3, "num_impl_steps", 0)):
            with record_function("ivdc"):
                q3, r = ivdc_solve(m3, self.dg3, q3, aux3, m3.ivdc_dt)
            res.append(r)
        return q3, res

    def explicit_step(self, q, aux, t):
        """The slow step without the IVDC solves."""
        if self.variant == "split01_3n":
            return self._step_3n(q, aux, t)
        q3, q2 = q
        aux3, aux2 = aux
        slow, dt = self.slow, self.dt
        split01 = self.variant == "split01"
        dq3 = None
        for s, window in enumerate(self.windows()):
            t_stage = t + slow.C[s] * dt
            last = s == self.nstages - 1
            if self.coupled:
                if split01 and s > 0:
                    # restart from the previous stage's mid-window save
                    q2 = self._from_save(q2, aux2)
                q3, aux3, aux2 = self._transfer(q3, aux3, aux2, t_stage)
            else:
                # the reference evaluates the slow RHS here too; only its
                # filter of q survives without the coupling
                q3 = self.dg3.pre_stage(q3, aux3, t_stage)
            # the slow tendency with ΔGᵘ; filtering again is part of the
            # trajectory (the exponential θ filter is not idempotent)
            q3, tend3, aux3 = self._slow_rhs(q3, aux3, t_stage)
            dq3 = tend3 if dq3 is None else slow.A[s] * dq3 + tend3
            fast_dt = window[3]
            if self.coupled and split01:
                # t_stage + (n − 1) fast_dt, summed as the JAX loop does
                times = [t_stage]
                for _ in range(window[2]):
                    times.append(times[-1] + fast_dt)
                q2, aux2 = self._fast_window(q2, aux2,
                                             lambda n: times[n - 1], window)
            else:
                q2, aux2 = self._fast(q2, aux2, t_stage, window[2], fast_dt)
            q3 = q3 + (slow.B[s] * dt) * dq3
            if self.coupled and split01:
                q3, q2, aux2 = self._reconcile_split01(q3, q2, aux2, last)
            elif self.coupled:
                q3, aux2 = self._reconcile(q3, q2, aux2)
        return (q3, q2), (aux3, aux2)

    def _step_3n(self, q, aux, t):
        """split01_3n: the slow 3N register walk (dQ += f; Q += b₁ dt dQ
        + b₂ dt dR; dR += a₂ dQ; dQ *= a₁) before each stage's fast window;
        the first stage keeps the input fast state, the middle ones restart
        from it, the last from the mid-window save."""
        q3, q2 = q
        aux3, aux2 = aux
        slow, dt = self.slow, self.dt
        rkA, rkB, nst = slow.RKA, slow.RKB, self.nstages
        dq3 = dr3 = None
        S2 = None
        for s, window in enumerate(self.windows()):
            t_stage = t + slow.RKC[s] * dt
            if s == 0:
                S2 = q2
            elif s == nst - 1:
                q2 = self._from_save(q2, aux2)
            else:
                q2 = S2
            q3, aux3, aux2 = self._transfer(q3, aux3, aux2, t_stage)
            q3, tend3, aux3 = self._slow_rhs(q3, aux3, t_stage)
            dq3 = tend3 if dq3 is None else dq3 + tend3
            q3 = q3 + (rkB[s, 0] * dt) * dq3
            if dr3 is not None and rkB[s, 1]:
                q3 = q3 + (rkB[s, 1] * dt) * dr3
            a2 = rkA[(s + 1) % nst, 1]
            if a2:
                dr3 = a2 * dq3 if dr3 is None else dr3 + a2 * dq3
            dq3 = rkA[(s + 1) % nst, 0] * dq3
            fast_dt, t0f = window[3], window[4]
            q2, aux2 = self._fast_window(
                q2, aux2, lambda n: t + t0f + (n - 1) * fast_dt, window)
            q3, q2, aux2 = self._reconcile_split01(q3, q2, aux2,
                                                   s == nst - 1)
        return (q3, q2), (aux3, aux2)
