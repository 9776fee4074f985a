"""Shared set-up of the numerics slice's parity tests: the JAX package's
small Held-Suarez configuration and the port's model on the JAX grid's
arrays, with the initial state from the port's ``init_ode_state`` on
that grid, as node-major arrays for the JAX package too (an eager JAX
``init_ode_state`` takes ~7 s on a CPU; the two inits agree to
round-off, tests/test_torch_held_suarez.py)."""

import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.experiments.held_suarez import \
    held_suarez_config
from climatemachine_tpu_torch.interop import (grid_from_numpy, grid_to_numpy,
                                              state_from_numpy,
                                              state_to_numpy)

SIZE = dict(n_horz=2, n_vert=3, poly_order=3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side of a module on one thread, restored after it: its
    tensors are small, and with pytest's workers sharing the cores a
    team of threads a process spends most of its time waiting (a test
    module here ran 30× slower with the default team than alone).  A
    test module takes it by importing it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def held_suarez_pair(seed: int, size=SIZE, dtype=np.float64,
                     winds: bool = True, **kw) -> dict:
    """The JAX config and DGModel (``cfg_j``, ``dg_j``); the port's model
    on the JAX grid's arrays (``grid_t``, ``dg_t``); the initial state
    ``q0``, ``aux0`` (node-major numpy) and ``q0_t``, ``aux0_t``
    (var-major); ``q`` / ``qt`` the state times 1 + 1e-3 · N(0, 1) from
    ``seed`` and, with ``winds``, N(0, 1) m/s winds.  ``kw`` goes to both
    packages' ``held_suarez_config``."""
    tdt = {np.float64: torch.float64, np.float32: torch.float32}[dtype]
    cfg_j = jax_held_suarez_config(dtype=dtype, **size, **kw)
    cfg_t = held_suarez_config(dtype=tdt, device="cpu", **size, **kw)
    grid_t = grid_from_numpy(grid_to_numpy(cfg_j.grid), device="cpu",
                             dtype=tdt)
    dg_t = DGModel(cfg_t.model, grid_t)
    q0_t, aux0_t = init_ode_state(dg_t)
    q0, aux0 = state_to_numpy(q0_t, aux0_t)
    rng = np.random.default_rng(seed)
    q = q0 * (1 + 1e-3 * rng.standard_normal(q0.shape))
    if winds:
        q[..., 1:4] = q[..., :1] * rng.standard_normal(q.shape[:-1] + (3,))
    q = q.astype(dtype)
    qt, auxt = state_from_numpy(q, aux0, device="cpu")
    return dict(cfg_j=cfg_j, dg_j=JaxDGModel(cfg_j.model, cfg_j.grid),
                cfg_t=cfg_t, grid_t=grid_t, dg_t=dg_t, q0=q0, aux0=aux0,
                q0_t=q0_t, aux0_t=aux0_t, q=q, qt=qt, auxt=auxt)
