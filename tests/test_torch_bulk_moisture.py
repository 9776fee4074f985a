"""tests/test_atmos_extras.py:463's set-up (BulkFormulaMoisture under a
5 m/s wind, EquilMoist, ConstantKinematicViscosity(0), 3 × 3 × 3
elements at p3) in the port against the JAX package, in float64 on the
CPU: the RHS at the state times 1 + 1e-3 · N(0, 1) within 1e-10 per
variable and 3 LSRK54 steps within 1e-10 of the JAX package's (its
stages eager around the jitted RHS), the column gaining water and mass
as the JAX test asks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu import driver_api as jcm
from climatemachine_tpu_torch import driver_api as cm
from forced_les_parity import var_err
from les_parity import nm, vm
from test_torch_lsforcing import TOL, _bulk_moisture, _pair, _rhs_err


@pytest.fixture(scope="module")
def bulk():
    return _pair(lambda: _bulk_moisture(jcm, jnp),
                 lambda: _bulk_moisture(cm, torch), nz=3)


def test_bulk_moisture_rhs_matches_jax(bulk):
    err = _rhs_err(bulk)
    assert np.all(err <= TOL), err


def test_bulk_moisture_steps_match_jax(bulk):
    """3 LSRK54 steps at the JAX test's dt (0.3 Δx_min / 360), from the
    JAX initial state; the column gains water and mass."""
    from climatemachine_tpu.ode.lsrk import LSRK54CarpenterKennedy as JLSRK
    d = bulk
    dt = 0.3 * cm.min_node_distance(d["pg"]) / 360.0
    jsolver = JLSRK(lambda a, b, t: d["rhs"](a, b, float(t)), dt)
    solver = cm.LSRK54CarpenterKennedy(d["dg"], dt)
    jq, jaux = jnp.asarray(d["jq"]), jnp.asarray(d["jaux"])
    q, aux = vm(d["jq"]), vm(d["jaux"])
    for i in range(3):
        jq, jaux = jsolver.step(jq, jaux, i * dt)
        q, aux = solver.step(q, aux, i * dt)
    err = var_err(nm(q), np.asarray(jq))
    assert np.all(err <= TOL), err
    M = d["pg"].M
    sl = d["pm"].prog_spec.index("moisture.rhoq_tot").start
    for lane in (sl, 0):
        assert torch.sum(M * q[:, lane]) > torch.sum(M * vm(d["jq"])[:, lane])
