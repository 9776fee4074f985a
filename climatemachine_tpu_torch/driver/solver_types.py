"""Solver-type strategy objects (port of
``climatemachine_tpu/driver/solver_types.py``: ``ExplicitSolverType``
:24-63, ``IMEXSolverType`` :66-178, ``_NonlinearColumnSolver`` :181-206,
``HEVISolverType`` :209-247, ``_BackwardEulerODESolver`` :250-275,
``ImplicitSolverType`` :278-295, ``SplitExplicitSolverType`` :298-329,
``MultirateSolverType`` :330-357 and ``MISSolverType`` :360-387).

``ExplicitSolverType().make(dg, q0, aux0, dt)`` builds LSRK54;
``IMEXSolverType().make(dg, q0, aux0, dt)`` builds the HEVI IMEX step:
ARK2GiraldoKellyConstantinescu whose implicit part is a column solver
over the vertical ``AtmosAcousticGravityLinearModel`` (its DGModel with
``dg``'s numerical flux).  ``state_layout`` picks the right-hand side:
"vm" the var-major RHS (dg/fast_rhs.py ``VarMajorRHS``), "grid" the
generic DG operator ``dg`` itself (the JAX package's node-major layout;
the port keeps its state var-major in both), "auto" the var-major RHS
where ``fast_rhs.supports(dg)`` holds (the Rusanov flux among its
conditions) and the generic operator otherwise (a Roe, HLLC or LMARS
flux, tracers, precipitation).
``columnwise_solver="dense"`` takes the dense ``ManyColumnSolver`` and
the ARK step's grid-layout loop on the fused remainder
``remainder_DGModel(dg, dg_lin)``, whatever the layout.
State and aux are var-major ``[E, n, Np]``; the caller sets
``post_step`` (the Held-Suarez filter) on the solver made.  A moist
model (EquilMoist) runs the var-major RHS with its aux lanes written on
every call, as the JAX package's does, or the generic DG operator: with
tracers or precipitation "auto" picks the generic operator (the
var-major RHS does not take them) and "vm" raises, as in the JAX
package.  ``MultirateSolverType().make`` builds the slow-fast multirate
step: the fast part the linear acoustic-gravity model in the model's
direction, the slow part the fused remainder, both generic DG operators.
``MISSolverType().make`` builds a multirate infinitesimal step (MIS2 by
default) on the same slow/fast split.  ``HEVISolverType().make`` an ARK
step (ARK2ImplicitExplicitMidpoint) whose implicit part is the full
model's vertical-direction DG operator, each stage solved by
Jacobian-free Newton-Krylov, and ``ImplicitSolverType().make`` backward
Euler on the full operator, solved the same way; both on the generic DG
operator.  ``SplitExplicitSolverType().make(dg3, dg2)`` builds the
split-explicit ocean's step (ocean/split_explicit.py): the slow method
over the 3-D operator, the fast one (LS3NRK33Heuns by default) over the
2-D one.
"""

from __future__ import annotations

import collections
import inspect
from dataclasses import dataclass
from typing import Callable

import torch

from climatemachine_tpu_torch.atmos.linear import \
    AtmosAcousticGravityLinearModel
from climatemachine_tpu_torch.dg import fast_rhs
from climatemachine_tpu_torch.dg.spatial import DGModel, remainder_DGModel
from climatemachine_tpu_torch.ode.ark import (ARK2GiraldoKellyConstantinescu,
                                              ARK2ImplicitExplicitMidpoint)
from climatemachine_tpu_torch.ode.lsrk import LSRK54CarpenterKennedy
from climatemachine_tpu_torch.ode.lsrk3n import LS3NRK33Heuns
from climatemachine_tpu_torch.ocean.split_explicit import SplitExplicitSolver
from climatemachine_tpu_torch.ode.mis import MIS2
from climatemachine_tpu_torch.ode.multirate import MultirateRungeKutta
from climatemachine_tpu_torch.solvers.columnwise import (
    BlockTridiagColumnSolver, ColumnLayout, ManyColumnSolver)
from climatemachine_tpu_torch.solvers.iterative import newton_krylov

STATE_LAYOUTS = ("auto", "vm", "grid")


def _refuse_unported(dg, state_layout: str):
    if state_layout not in STATE_LAYOUTS:
        raise ValueError(f"state_layout must be one of {STATE_LAYOUTS}, "
                         f"got {state_layout!r}")
    if hasattr(dg, "inner") and hasattr(dg, "mesh"):
        raise NotImplementedError("next slice: a sharded DGModel")


def _var_major_rhs(dg) -> fast_rhs.VarMajorRHS:
    """The var-major RHS, its dry aux lanes deferred to ``export_aux``
    (a moist model writes its lanes on every call)."""
    return fast_rhs.VarMajorRHS(dg, write_aux=dg.balance_law.moist)


def _generic(dg, state_layout: str) -> bool:
    """Whether the explicit part runs on the generic DG operator: with
    "grid", and with "auto" where the var-major RHS does not take ``dg``
    (as the JAX package chooses, solver_types.py:33-51); "vm" where it
    does not raises."""
    if state_layout == "vm" and not fast_rhs.supports(dg):
        raise ValueError("state_layout='vm' requested but the var-major "
                         "RHS does not take this configuration")
    return state_layout == "grid" or (state_layout == "auto"
                                      and not fast_rhs.supports(dg))


@dataclass
class ExplicitSolverType:
    """Explicit time stepping.  On the var-major RHS (``state_layout``
    "vm", or "auto" where ``fast_rhs.supports(dg)``): ``solver.vm`` is
    that RHS (:class:`VarMajorRHS`, built with ``write_aux=False``: call
    ``solver.vm.export_aux`` when aux leaves the loop; with a moist model
    ``write_aux=True``).  On ``dg`` itself ("grid", or "auto" where the
    var-major RHS does not take it, e.g. with a Roe or HLLC flux, with
    tracers or with precipitation), with ``dg.pre_stage`` before each
    stage; ``solver.vm`` is None.  A method that takes no ``pre_stage``
    (SSPRK) runs there only where the balance law's
    ``preprocess_state`` is the identity: the JAX type builds it without
    the projection whatever the law (JAX solver_types.py:52-56), which
    the port refuses."""
    solver_method: Callable = LSRK54CarpenterKennedy
    state_layout: str = "auto"

    def getdtmodel(self, bl):
        """The model whose Courant number sets dt: the balance law."""
        return bl

    def make(self, dg: DGModel, q0, aux0, dt: float):
        _refuse_unported(dg, self.state_layout)
        if _generic(dg, self.state_layout):
            if "pre_stage" in inspect.signature(
                    self.solver_method).parameters:
                solver = self.solver_method(dg, dt, pre_stage=dg.pre_stage)
            elif dg.balance_law.preprocess_is_identity:
                solver = self.solver_method(dg, dt)
            else:
                raise ValueError(
                    f"{getattr(self.solver_method, '__name__', 'the method')}"
                    " takes no pre_stage, and this balance law's "
                    "preprocess_state is not the identity (the JAX package "
                    "would drop it)")
            solver.vm = None
            return solver
        vm = _var_major_rhs(dg)
        solver = self.solver_method(vm, dt)
        solver.vm = vm
        return solver


@dataclass
class IMEXSolverType:
    """HEVI IMEX: implicit operator = the vertical-direction linear model
    ``implicit_model(atmos)``, solved columnwise; the explicit part is
    the full RHS with the linear split absorbed into the stage algebra
    (the banded solver's block loop: ``rhs_full`` is the var-major RHS, or
    ``dg`` with ``state_layout="grid"`` or with "auto" where the var-major
    RHS does not take it), or the fused remainder ``dg − dg_lin`` (the
    dense solver's grid-layout loop); ``dg_lin`` has ``dg``'s numerical
    flux.

    ``check_frozen_operator``: at set-up, refuse a linear operator that
    changes with aux or t (the factorization freezes it at (aux0, 0))."""
    implicit_model: Callable = AtmosAcousticGravityLinearModel
    solver_method: Callable = ARK2GiraldoKellyConstantinescu
    columnwise_solver: str = "banded"
    check_frozen_operator: bool = True
    state_layout: str = "auto"

    def getdtmodel(self, bl):
        """The model whose Courant number sets dt: the implicit linear
        model (the rest of the dynamics is treated implicitly)."""
        return self.implicit_model(bl)

    def make(self, dg: DGModel, q0, aux0, dt: float):
        dense = self.columnwise_solver == "dense"
        _refuse_unported(dg, self.state_layout)
        generic = dense or _generic(dg, self.state_layout)
        solver_cls = {"banded": BlockTridiagColumnSolver,
                      "dense": ManyColumnSolver}.get(self.columnwise_solver)
        if solver_cls is None:
            raise ValueError("columnwise_solver must be 'banded' or 'dense', "
                             f"got {self.columnwise_solver!r}")
        atmos, grid = dg.balance_law, dg.grid
        dg_lin = DGModel(self.implicit_model(atmos), grid,
                         direction="vertical", update_aux=False,
                         numerical_flux_first_order=dg.nf1)

        if self.check_frozen_operator:
            f0, _ = dg_lin(q0, aux0, 0.0)
            aux_p = atmos.update_auxiliary_state(q0 * 1.001, aux0, grid)
            f1, _ = dg_lin(q0, aux_p, 86400.0)
            scale = f0.abs().max().item() + 1e-300
            tol = 1e-5 if q0.dtype == torch.float32 else 1e-11
            err = (f1 - f0).abs().max().item()
            if err > tol * scale:
                raise ValueError(
                    "IMEX implicit operator is aux/t-dependent (relative "
                    f"drift {err / scale:.3e}); the frozen columnwise "
                    "factorization would be stale")

        col_solver = solver_cls(lambda x: dg_lin(x, aux0, 0.0)[0],
                                ColumnLayout(grid, atmos.prog_spec.num), q0)

        def rhs_im(q, aux, t):
            return dg_lin(q, aux, t)[0], aux

        if dense:
            solver = self.solver_method(remainder_DGModel(dg, dg_lin),
                                        rhs_im, col_solver, dt)
            solver.vm = None
        elif generic:
            solver = self.solver_method(None, rhs_im, col_solver, dt,
                                        rhs_full=dg)
            solver.vm = None
        else:
            vm = _var_major_rhs(dg)
            solver = self.solver_method(None, rhs_im, col_solver, dt,
                                        rhs_full=vm)
            solver.vm = vm
        # eager factorization for every distinct implicit diagonal
        for g in sorted({float(solver.A_im[i, i])
                         for i in range(solver.nstages)} - {0.0}):
            col_solver.prefactorize(g * dt)
        return solver


@dataclass
class SplitExplicitSolverType:
    """The ocean's barotropic/baroclinic split: the slow 3-D method at
    ``dt_slow``, the fast 2-D one substepping at ``dt_fast``, each with
    its operator's ``pre_stage``; ``make`` takes both DG operators (the
    3-D and the 2-D) and the split's dts, the fields where not given."""
    dt_slow: float = 0.0
    dt_fast: float = 0.0
    slow_method: Callable = LSRK54CarpenterKennedy
    fast_method: Callable = LS3NRK33Heuns

    def make(self, dg3: DGModel, dg2: DGModel, dt_slow: float = None,
             dt_fast: float = None):
        dts = float(dt_slow if dt_slow is not None else self.dt_slow)
        dtf = float(dt_fast if dt_fast is not None else self.dt_fast)
        slow = self.slow_method(dg3, dts, pre_stage=dg3.pre_stage)
        fast = self.fast_method(dg2, dtf, pre_stage=dg2.pre_stage)
        solver = SplitExplicitSolver(slow, fast, dg3, dg2, dt=dts,
                                     fast_dt=dtf)
        solver.vm = None
        return solver


@dataclass
class MultirateSolverType:
    """Slow-fast multirate: the fast operator is ``fast_model(atmos)`` (the
    linear acoustic-gravity model) in ``dg``'s direction, the slow one the
    fused remainder ``remainder_DGModel(dg, dg_fast)``; ``dt`` drives the
    slow solver and the fast one substeps at ``dt / timestep_ratio``.
    Both are generic DG operators: on the card the slow one runs the dry
    volume kernel's remainder branch with ``lin_dims`` (0, 1, 2) where
    ``dg`` discretizes every direction.  ``solver.vm`` is None."""
    fast_model: Callable = AtmosAcousticGravityLinearModel
    slow_method: Callable = LSRK54CarpenterKennedy
    fast_method: Callable = LSRK54CarpenterKennedy
    timestep_ratio: int = 100

    def getdtmodel(self, bl):
        """The model with the most restrictive dt: the fast one."""
        return self.fast_model(bl)

    def make(self, dg: DGModel, q0, aux0, dt: float):
        _refuse_unported(dg, "grid")
        dg_fast = DGModel(self.fast_model(dg.balance_law), dg.grid,
                          direction=dg.direction, update_aux=False,
                          numerical_flux_first_order=dg.nf1)
        slow = self.slow_method(remainder_DGModel(dg, dg_fast), dt)
        fast = self.fast_method(dg_fast, dt / self.timestep_ratio)
        solver = MultirateRungeKutta(slow, fast, dt=dt)
        solver.vm = None
        return solver


@dataclass
class MISSolverType:
    """Multirate infinitesimal step on the slow-fast split of
    :class:`MultirateSolverType`: the fast operator ``fast_model(atmos)``
    in ``dg``'s direction, the slow one the fused remainder; each slow
    stage's fast ODE runs in ⌈``nsubsteps`` · d_i⌉ steps of
    ``fast_method`` (LSRK54, or SSPRK33ShuOsher, ...).  ``mis_method``
    MIS2 unless given (ode/mis.py: MIS2, MIS3C, MISRK3).  On the card the
    slow operator runs the dry volume kernel's remainder branch
    ``lin_dims`` (0, 1, 2) with gravity; the fast linear model is plain
    torch.  ``solver.vm`` is None."""
    fast_model: Callable = AtmosAcousticGravityLinearModel
    mis_method: Callable = None
    fast_method: Callable = LSRK54CarpenterKennedy
    nsubsteps: int = 10

    def getdtmodel(self, bl):
        """The model with the most restrictive dt: the fast one."""
        return self.fast_model(bl)

    def make(self, dg: DGModel, q0, aux0, dt: float):
        _refuse_unported(dg, "grid")
        dg_fast = DGModel(self.fast_model(dg.balance_law), dg.grid,
                          direction=dg.direction, update_aux=False,
                          numerical_flux_first_order=dg.nf1)
        solver = (self.mis_method or MIS2)(
            remainder_DGModel(dg, dg_fast), dg_fast, self.fast_method,
            nsubsteps=self.nsubsteps, dt=dt)
        solver.vm = None
        return solver


#: each Newton-Krylov solve's residuals kept by the implicit solvers below
RESIDUAL_HISTORY = 64


class _NonlinearColumnSolver:
    """The implicit stages' solver for a nonlinear operator: F(Q) = Q −
    α·dt·f_im(Q, aux0, t0) − rhs = 0 by Jacobian-free Newton-Krylov
    (``n_newton`` steps, each a GMRES cycle of ``n_krylov``, the
    difference step ``fd_eps``).  ``residuals`` keeps the last solves'
    (‖F(Q)‖ as a 0-d tensor, each Newton step's GMRES least-squares
    residual)."""

    def __init__(self, rhs_im, aux0, t0: float = 0.0, n_newton: int = 10,
                 n_krylov: int = 30, fd_eps: float = 1e-10):
        self.rhs_im = rhs_im
        self.aux0 = aux0
        self.t0 = t0
        self.n_newton = n_newton
        self.n_krylov = n_krylov
        self.fd_eps = fd_eps
        self.residuals = collections.deque(maxlen=RESIDUAL_HISTORY)

    def solve(self, rhs, alpha_dt: float):
        def F(qq):
            return qq - alpha_dt * self.rhs_im(qq, self.aux0, self.t0)[0] \
                - rhs

        gm = []
        x, res = newton_krylov(F, rhs, n_newton=self.n_newton,
                               n_krylov=self.n_krylov, fd_eps=self.fd_eps,
                               record=gm)
        self.residuals.append((res, gm))
        return x


@dataclass
class HEVISolverType:
    """Horizontally explicit, vertically implicit with the full
    (nonlinear) vertical dynamics implicit: the implicit operator is the
    vertical-direction DG operator of the full balance law (its
    hyperdiffusion keeps its own direction), solved per stage by
    Jacobian-free Newton-Krylov (:class:`_NonlinearColumnSolver` at aux0
    and t = 0), the explicit part the full operator minus that one.  The
    vertical operator keeps ``dg``'s numerical flux and its chain and
    surface options.  On the card the full operator runs the dry volume
    kernel; the vertical one, whose direction the kernel does not take,
    runs plain torch volume and face passes and the chain kernels.
    ``solver.solver.residuals`` holds the solves' residuals;
    ``solver.vm`` is None."""
    solver_method: Callable = ARK2ImplicitExplicitMidpoint
    nonlinear_max_iterations: int = 10
    linear_max_subspace_size: int = 30
    nonlinear_eps: float = 1e-10

    def getdtmodel(self, bl):
        """The model whose Courant number sets dt: the balance law."""
        return bl

    def make(self, dg: DGModel, q0, aux0, dt: float):
        _refuse_unported(dg, "grid")
        # dg's kernel options but its volume kernel's, which takes every
        # direction only ("pallas" would refuse the vertical operator)
        vdg = DGModel(dg.balance_law, dg.grid, direction="vertical",
                      update_aux=False, numerical_flux_first_order=dg.nf1,
                      volume_kernel=("xla" if dg.volume_kernel == "xla"
                                     else "auto"),
                      surface_kernel=dg.surface_kernel,
                      ldg_kernel=dg.ldg_kernel, chain_stages=dg.chain_stages)

        def rhs_ex(q, aux, t):
            full, aux = dg(q, aux, t)
            return full - vdg(q, aux, t)[0], aux

        def rhs_im(q, aux, t):
            return vdg(q, aux, t)[0], aux

        col_solver = _NonlinearColumnSolver(
            rhs_im, aux0, n_newton=self.nonlinear_max_iterations,
            n_krylov=self.linear_max_subspace_size,
            fd_eps=self.nonlinear_eps)
        solver = self.solver_method(rhs_ex, rhs_im, col_solver, dt)
        solver.vm = None
        return solver


class _BackwardEulerODESolver:
    """Backward Euler on the whole model, each step F(q₁) = q₁ − dt·
    f(q₁, aux, t + dt) − q = 0 solved by Jacobian-free Newton-Krylov
    (difference step 1e-7, the JAX function's default); aux then comes
    from one more call at q₁.  ``residuals`` as
    :class:`_NonlinearColumnSolver`'s."""

    def __init__(self, rhs, dt: float, n_newton: int = 10,
                 n_krylov: int = 30):
        self.rhs = rhs
        self.dt = float(dt)
        self.n_newton = n_newton
        self.n_krylov = n_krylov
        self.dt_fixed = True
        self.residuals = collections.deque(maxlen=RESIDUAL_HISTORY)

    def step(self, q, aux, t: float):
        dt = self.dt

        def F(qq):
            return qq - dt * self.rhs(qq, aux, t + dt)[0] - q

        gm = []
        q1, res = newton_krylov(F, q, n_newton=self.n_newton,
                                n_krylov=self.n_krylov, record=gm)
        self.residuals.append((res, gm))
        _, aux1 = self.rhs(q1, aux, t + dt)
        return q1, aux1


@dataclass
class ImplicitSolverType:
    """Fully implicit stepping: ``solver_method`` (backward Euler by
    Newton-Krylov) on the whole generic DG operator, whose dt no
    wavespeed limits, only accuracy (and Newton's convergence).  Its
    difference step, relative to the state's norm, is below float32's
    resolution, as HEVI's: it converges in float64.  ``solver.vm`` is
    None."""
    solver_method: Callable = _BackwardEulerODESolver
    n_newton: int = 10
    n_krylov: int = 30

    def getdtmodel(self, bl):
        """The model whose Courant number sets dt: the balance law."""
        return bl

    def make(self, dg: DGModel, q0, aux0, dt: float):
        _refuse_unported(dg, "grid")
        solver = self.solver_method(dg, dt, n_newton=self.n_newton,
                                    n_krylov=self.n_krylov)
        solver.vm = None
        return solver
