"""Implicit vertical diffusion and convective adjustment, IVDC (port of
``climatemachine_tpu/ocean/ivdc.py``: ``IVDCModel`` :28,
``ivdc_coefficients`` :86, ``ivdc_solve`` :95).

A linear balance law for L(θ) = θ/Δt − ∂z(κ ∂zθ), κ frozen from the
pre-step stratification (κᶜ where ∂θ/∂z < 0, else κᶻ/2), with
insulating ends; one backward-Euler step solves L θⁿ⁺¹ = θⁿ/Δt by
restarted GMRES (solvers/iterative.py) over the whole grid at once, the
operator the vertical-direction generic DG operator.  Plain PyTorch: the
JAX package runs it in XLA, no Pallas kernel.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from climatemachine_tpu_torch.balance_laws.interface import BalanceLaw
from climatemachine_tpu_torch.solvers.iterative import gmres
from climatemachine_tpu_torch.utils.variables import VarSpec


class IVDCModel(BalanceLaw):
    """The operator's balance law: prognostic θ, aux the frozen κ per node;
    its DG tendency −∇·F₂ + S with F₂ = (0, 0, κ ∂zθ) and S = θ/Δt is
    L(θ)."""

    def __init__(self, kappa_z: float, kappa_c: float, dt: float):
        self.kappa_z, self.kappa_c, self.dt = kappa_z, kappa_c, dt
        self.prog_spec = VarSpec(theta=1)
        self.aux_spec = VarSpec(coord=3, kappa=1)
        self.grad_spec = VarSpec(theta=1)
        self.gf_spec = VarSpec(kappa_dz_theta=3)

    def init_state_prognostic(self, coords, aux, t):
        return coords.new_zeros((coords.shape[0], 1, coords.shape[-1]))

    def compute_gradient_argument(self, q, aux, t):
        return q

    def compute_gradient_flux(self, grad_g, q, aux, t):
        """(0, 0, κ ∂zθ)."""
        out = q.new_zeros((q.shape[0], 3, q.shape[-1]))
        out[:, 2] = self.aux_spec.get(aux, "kappa") * grad_g[:, 2, 0]
        return out

    def flux_second_order(self, q, gf, hyper, aux, t):
        return gf[:, :, None]

    def source(self, q, aux, t, gf=None):
        return q / self.dt

    def boundary_conditions(self):
        return (1, 2)

    def boundary_state_gradient_flux(self, tag, nrm, gf_minus, q_minus,
                                     aux_minus, t):
        """Insulating: reflected, so that the central flux vanishes."""
        return -gf_minus


def ivdc_coefficients(model, dg_hb, q, aux):
    """κ ``[E, Np]`` from the state's stratification: κᶜ where the
    vertical DG derivative of θ is negative, else κᶻ/2."""
    theta = model.prog(q, "theta")
    dthdz = dg_hb.dg_gradient_of(theta[:, None], direction="vertical")[:, 2,
                                                                       0]
    return torch.where(dthdz < 0, torch.full_like(dthdz, model.kappa_c),
                       torch.full_like(dthdz, 0.5 * model.kappa_z))


def _operator(model, dg_hb, dt):
    """(the IVDC DG operator, its aux without κ) on ``dg_hb``'s grid,
    built once per (Δt, κᶻ, κᶜ) and kept in ``dg_hb``'s cache."""
    from climatemachine_tpu_torch.dg.spatial import (DGModel,
                                                     init_state_auxiliary)

    def build():
        ivdc = IVDCModel(model.kappa_z, model.kappa_c, dt)
        return (DGModel(ivdc, dg_hb.grid, direction="vertical"),
                init_state_auxiliary(ivdc, dg_hb.grid))
    return dg_hb._cached(("ivdc", float(dt), model.kappa_z, model.kappa_c),
                         build)


def ivdc_solve(model, dg_hb, q, aux, dt, n_krylov: int = 24,
               restarts: int = 2):
    """One backward-Euler IVDC step on the temperature of a hydrostatic
    Boussinesq state q: L θⁿ⁺¹ = θⁿ/Δt by GMRES from 0, κ from q.
    Returns (q with θ replaced, GMRES's final ‖b − L x‖ / ‖b‖ with b =
    θⁿ/Δt, a 0-d tensor on the device); the JAX function returns the
    state alone.  GMRES runs in a profiler span ``gmres``."""
    dg_op, aux0 = _operator(model, dg_hb, dt)
    aux_op = aux0.clone()
    aux_op[:, dg_op.balance_law.aux_spec.index("kappa")] = \
        ivdc_coefficients(model, dg_hb, q, aux)[:, None]
    theta_n = model.prog(q, "theta")[:, None]

    def L(x):
        return dg_op(x.reshape(theta_n.shape), aux_op, 0.0)[0].reshape(-1)

    b = (theta_n / dt).reshape(-1)
    with record_function("gmres"):
        sol, res = gmres(L, b, n_krylov=n_krylov, restarts=restarts)
    out = q.clone()
    out[:, model.prog_spec.index("theta")] = sol.reshape(theta_n.shape)
    bn = torch.linalg.vector_norm(b)
    return out, res / torch.where(bn == 0, torch.ones_like(bn), bn)
