"""One LSRK54 step of ``gcm_driver_config``'s moist heldsuarez (n_horz 2,
n_vert 2, p3, float64 on the CPU) in the port against the JAX package's
step (its RHS jitted, the stages eager), within 1e-10 relative per
variable; the mass kept within 1e-8 relative.  Its bulk surface-flux
variant: tests/test_torch_gcm_driver_bulk.py.  Apart from
tests/test_torch_gcm_driver.py, one case a file: each JAX RHS compiles
for 6-12 s.
"""

import jax
import jax.numpy as jnp
import torch

from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import \
    init_state_auxiliary as jax_init_aux
from climatemachine_tpu.ode.lsrk import \
    LSRK54CarpenterKennedy as JaxLSRK54
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.interop import to_node_major
from climatemachine_tpu_torch.mesh.grid import min_node_distance
from climatemachine_tpu_torch.ode.lsrk import LSRK54CarpenterKennedy
from test_torch_gcm_driver import configs, rel_err_per_var

STEP_TOL = 1e-10


class JittedRHS:
    def __init__(self, dg):
        self._call = jax.jit(lambda q, a, t: dg(q, a, t))

    def __call__(self, q, aux, t):
        return self._call(q, aux, float(t))


def one_step_against_jax(case):
    """One LSRK54 step of ``case`` (tests/test_torch_gcm_driver.py
    ``CASES``) in both packages from the port's initial state."""
    cj, ct = configs(case)
    dg = DGModel(ct.model, ct.grid)
    q, aux = init_ode_state(dg)
    dt = 0.3 * min_node_distance(ct.grid) / 350.0
    q1, aux1 = LSRK54CarpenterKennedy(dg, dt).step(q, aux, 0.0)
    qj, aj = jnp.asarray(to_node_major(q)), jax_init_aux(cj.model, cj.grid)
    q1j, _ = JaxLSRK54(JittedRHS(JaxDGModel(cj.model, cj.grid)), dt).step(
        qj, aj, 0.0)
    assert max(rel_err_per_var(to_node_major(q1), q1j)) < STEP_TOL
    assert bool(torch.isfinite(q1).all())
    m = lambda x: float(torch.sum(ct.grid.M * x[:, 0]))
    assert abs(m(q1) - m(q)) / m(q) < 1e-8
    return q1


def test_one_lsrk54_step():
    one_step_against_jax("hs_default")
