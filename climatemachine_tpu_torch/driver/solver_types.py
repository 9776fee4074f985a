"""Solver-type strategy objects (port of
``climatemachine_tpu/driver/solver_types.py`` ``ExplicitSolverType``
:24-63 and ``IMEXSolverType`` :66-178, their var-major paths).

``ExplicitSolverType().make(dg, q0, aux0, dt)`` builds LSRK54 on the
var-major RHS (dg/fast_rhs.py); ``IMEXSolverType().make(dg, q0, aux0,
dt)`` builds the HEVI IMEX step: ARK2GiraldoKellyConstantinescu whose
implicit part is a ``BlockTridiagColumnSolver`` over the vertical
``AtmosAcousticGravityLinearModel``, with the full var-major RHS as
``rhs_full``.  State and aux are var-major ``[E, n, Np]``; the caller
sets ``post_step`` (the Held-Suarez filter) on the solver made.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from climatemachine_tpu_torch.atmos.linear import \
    AtmosAcousticGravityLinearModel
from climatemachine_tpu_torch.dg.fast_rhs import VarMajorRHS
from climatemachine_tpu_torch.dg.spatial import DGModel
from climatemachine_tpu_torch.ode.ark import ARK2GiraldoKellyConstantinescu
from climatemachine_tpu_torch.ode.lsrk import LSRK54CarpenterKennedy
from climatemachine_tpu_torch.solvers.columnwise import (
    BlockTridiagColumnSolver, ColumnLayout)


def _refuse_unported(dg, state_layout: str):
    if state_layout not in ("auto", "vm"):
        raise NotImplementedError(
            f"next slice: state_layout={state_layout!r} (the node-major "
            "step on the generic DG operator)")
    if hasattr(dg, "inner") and hasattr(dg, "mesh"):
        raise NotImplementedError("next slice: a sharded DGModel")


@dataclass
class ExplicitSolverType:
    """Explicit time stepping on the full var-major RHS.  ``solver.vm``
    is that RHS (:class:`VarMajorRHS`, built with ``write_aux=False``:
    call ``solver.vm.export_aux`` when aux leaves the loop).  In the JAX
    package ``"auto"`` falls back to the generic DG operator for a
    configuration the var-major RHS does not take; here VarMajorRHS
    raises for it.  ``state_layout="grid"`` is not ported and raises."""
    solver_method: Callable = LSRK54CarpenterKennedy
    state_layout: str = "auto"

    def make(self, dg: DGModel, q0, aux0, dt: float):
        _refuse_unported(dg, self.state_layout)
        vm = VarMajorRHS(dg, write_aux=False)
        solver = self.solver_method(vm, dt)
        solver.vm = vm
        return solver


@dataclass
class IMEXSolverType:
    """HEVI IMEX: implicit operator = the vertical-direction linear model
    ``implicit_model(atmos)``, solved columnwise; the explicit part is
    the full RHS with the linear split absorbed into the stage algebra.

    ``check_frozen_operator``: at set-up, refuse a linear operator that
    changes with aux or t (the factorization freezes it at (aux0, 0)).
    ``columnwise_solver="dense"`` and ``state_layout="grid"`` (the JAX
    package's node-major path with its fused remainder) are not ported
    and raise."""
    implicit_model: Callable = AtmosAcousticGravityLinearModel
    solver_method: Callable = ARK2GiraldoKellyConstantinescu
    columnwise_solver: str = "banded"
    check_frozen_operator: bool = True
    state_layout: str = "auto"

    def make(self, dg: DGModel, q0, aux0, dt: float):
        _refuse_unported(dg, self.state_layout)
        if self.columnwise_solver != "banded":
            raise NotImplementedError(
                f"next slice: columnwise_solver={self.columnwise_solver!r}")
        atmos, grid = dg.balance_law, dg.grid
        rhs_full = VarMajorRHS(dg, write_aux=False)
        dg_lin = DGModel(self.implicit_model(atmos), grid,
                         direction="vertical", update_aux=False)

        if self.check_frozen_operator:
            f0, _ = dg_lin(q0, aux0, 0.0)
            aux_p = atmos.update_auxiliary_state(q0 * 1.001, aux0)
            f1, _ = dg_lin(q0, aux_p, 86400.0)
            scale = f0.abs().max().item() + 1e-300
            tol = 1e-5 if q0.dtype == torch.float32 else 1e-11
            err = (f1 - f0).abs().max().item()
            if err > tol * scale:
                raise ValueError(
                    "IMEX implicit operator is aux/t-dependent (relative "
                    f"drift {err / scale:.3e}); the frozen columnwise "
                    "factorization would be stale")

        col_solver = BlockTridiagColumnSolver(
            lambda x: dg_lin(x, aux0, 0.0)[0],
            ColumnLayout(grid, atmos.prog_spec.num), q0)

        def rhs_im(q, aux, t):
            return dg_lin(q, aux, t)[0], aux

        solver = self.solver_method(None, rhs_im, col_solver, dt,
                                    rhs_full=rhs_full)
        # eager factorization for every distinct implicit diagonal
        for g in sorted({float(solver.A_im[i, i])
                         for i in range(solver.nstages)} - {0.0}):
            col_solver.prefactorize(g * dt)
        return solver
