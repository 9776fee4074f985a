"""The balance-law base (port of ``climatemachine_tpu/balance_laws/
interface.py`` :32-156): dq/dt = −∇·F₁(q) − ∇·F₂(q, ∇g) + S.

Hooks act on var-major face or volume lanes, in the port's signatures,
which :class:`~climatemachine_tpu_torch.dg.spatial.DGModel` calls: q
``[E, n, L]``, aux ``[E, naux, L]``, fluxes ``[E, d, n, L]`` (direction
i, then variable; d = 3, or 2 for a model on a 2-D grid), gradient
arguments ``[E, ng, L]``, gradients ``[E, d, ng, L]``, gradient fluxes
``[E, ngf, L]``, unit normals ``[E, d, X]``.  A subclass sets ``prog_spec`` and ``aux_spec`` and overrides the
hooks it needs; the defaults are the JAX package's: no gradient or
gradient-Laplacian lanes, zero fluxes, wave speed and source, identity
``preprocess_state``, ``update_auxiliary_state`` and
``update_auxiliary_state_gradient``, wall ghosts that copy the minus
side, and no column integrals.  A balance law that prescribes wall
diffusive fluxes defines ``boundary_flux_second_order``, one whose
Rusanov dissipation departs from the jump ``numerical_flux_penalty``:
the base defines neither, so the DG operator leaves both steps out.
``update_auxiliary_state(q, aux, grid)`` gets the grid, as the JAX hook
does, for a refresh that reads it (the coupled ocean's column total).
"""

from __future__ import annotations

from typing import Tuple

import torch

from climatemachine_tpu_torch.balance_laws import state_types as st
from climatemachine_tpu_torch.utils.variables import VarSpec


class BalanceLaw:
    """A PDE in balance-law form; subclasses are configuration objects
    fixed before the first call."""

    prog_spec: VarSpec = VarSpec()
    aux_spec: VarSpec = VarSpec()
    grad_spec: VarSpec = VarSpec()
    gf_spec: VarSpec = VarSpec()
    gradlap_spec: VarSpec = VarSpec()

    # ------ schemas --------------------------------------------------------
    def vars_state(self, state_type) -> VarSpec:
        """The schema of a state category."""
        return {st.Prognostic(): self.prog_spec,
                st.Auxiliary(): self.aux_spec,
                st.Gradient(): self.grad_spec,
                st.GradientFlux(): self.gf_spec,
                st.GradientLaplacian(): self.gradlap_spec}.get(
                    state_type, VarSpec())

    def num_state(self, state_type) -> int:
        return self.vars_state(state_type).num

    def _zeros(self, q, *shape):
        return torch.zeros((q.shape[0],) + shape + (q.shape[-1],),
                           dtype=q.dtype, device=q.device)

    # ------ initialization -------------------------------------------------
    def nodal_init_state_auxiliary(self, coords, aux, grid):
        """Fill the model's aux lanes from coords ``[E, 3, Np]`` and the
        grid; aux arrives with ``coord`` set."""
        return aux

    def init_state_prognostic(self, coords, aux, t):
        """The initial state ``[E, n, Np]``."""
        raise NotImplementedError

    # ------ first-order terms ----------------------------------------------
    def flux_first_order(self, q, aux, t):
        return self._zeros(q, 3, self.prog_spec.num)

    def source(self, q, aux, t, gf=None):
        return torch.zeros_like(q)

    def wavespeed(self, nrm, q, aux, t):
        """The largest signal speed along ``nrm``, ``[E, L]``."""
        return q.new_zeros((q.shape[0], q.shape[-1]))

    # ------ second-order terms ---------------------------------------------
    def compute_gradient_argument(self, q, aux, t):
        return self._zeros(q, self.grad_spec.num)

    def compute_gradient_flux(self, grad_g, q, aux, t):
        return self._zeros(q, self.gf_spec.num)

    def flux_second_order(self, q, gf, hyper, aux, t):
        return self._zeros(q, 3, self.prog_spec.num)

    # ------ boundary conditions --------------------------------------------
    def boundary_conditions(self) -> Tuple:
        """The boundary conditions; face tag k selects entry k − 1."""
        return ()

    def boundary_state(self, tag: int, nrm, q_minus, aux_minus, t):
        """The ghost (q⁺, aux⁺) on wall lanes of tag ``tag``: the minus
        side."""
        return q_minus, aux_minus

    def boundary_state_gradient_flux(self, tag: int, nrm, gf_minus, q_minus,
                                     aux_minus, t):
        """The gradient-flux ghost on wall lanes: the minus side."""
        return gf_minus

    # ------ auxiliary updates ----------------------------------------------
    def update_auxiliary_state(self, q, aux, grid):
        """The aux refresh at the start of each RHS call."""
        return aux

    def preprocess_state(self, dg, q, aux, t):
        """The state projection before each stage (``DGModel.pre_stage``):
        the identity."""
        return q

    #: whether :meth:`preprocess_state` is the identity: an explicit
    #: method that takes no ``pre_stage`` (SSPRK) runs only such a law
    preprocess_is_identity = True

    def update_auxiliary_state_gradient(self, dg, gf, q, aux, t):
        """The aux update that reads the gradient flux, after the
        gradient pass.  Returns (aux, q)."""
        return aux, q

    # ------ column integrals -----------------------------------------------
    def integral_load_auxiliary_state(self, q, aux, t):
        return self._zeros(q, self.num_state(st.UpwardIntegrals()))

    def integral_set_auxiliary_state(self, aux, integrals):
        return aux

    def reverse_integral_load_auxiliary_state(self, q, aux, t):
        return self._zeros(q, self.num_state(st.DownwardIntegrals()))

    def reverse_integral_set_auxiliary_state(self, aux, integrals):
        return aux
