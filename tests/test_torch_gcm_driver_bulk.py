"""One LSRK54 step of ``gcm_driver_config``'s moist heldsuarez with the
bulk surface fluxes (``surface_flux="bulk"``: VaryingSSTTJ16's
temperature and humidity through BulkFormulaEnergy and
BulkFormulaMoisture) in the port against the JAX package's step, as
tests/test_torch_gcm_driver_step.py holds the default walls; and the
bulk fluxes act: the step differs from the default walls' near the
surface.
"""

import torch

from test_torch_gcm_driver_step import one_step_against_jax
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.ode.lsrk import LSRK54CarpenterKennedy
from climatemachine_tpu_torch.mesh.grid import min_node_distance
from test_torch_gcm_driver import configs


def test_one_lsrk54_step_bulk():
    q_bulk = one_step_against_jax("hs_bulk")
    _, ct = configs("hs_default")
    dg = DGModel(ct.model, ct.grid)
    q, aux = init_ode_state(dg)
    dt = 0.3 * min_node_distance(ct.grid) / 350.0
    q1, _ = LSRK54CarpenterKennedy(dg, dt).step(q, aux, 0.0)
    assert not torch.equal(q1, q_bulk)
