"""The reference caveat of HEVI in float32 (ROADMAP queue 3), in both
packages on the CPU: the Newton-Krylov difference step ε = 1e-10·(‖x‖ +
1) of ``HEVISolverType`` lies below float32's resolution (the state's
ρe ~1e5 beside ρ ~1), so the Jacobian products are round-off and the
solve does not converge, in the JAX package as in the port.  HEVI's
first implicit solve (α = dt/2 of the IMEX midpoint at 0.1 of the
horizontal acoustic limit) at n_horz=2, n_vert=3, p3, from a seeded
perturbation of the initial state (tests/numerics_parity.py), 3 Newton
steps of GMRES(20): ‖F‖
stays above half its start in both packages in float32 (measured 1.070
in JAX, 1.056 in the port), while the port in float64 takes it below
0.05 of its start (measured 0.0107).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from climatemachine_tpu.dg.spatial import VERTICAL
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu.solvers import iterative as jiterative
from climatemachine_tpu_torch.dg.spatial import DGModel
from climatemachine_tpu_torch.interop import grid_from_numpy, grid_to_numpy
from climatemachine_tpu_torch.solvers.iterative import newton_krylov
from numerics_parity import held_suarez_pair, one_torch_thread  # noqa: F401

NEWTON = dict(n_newton=3, n_krylov=20, fd_eps=1e-10)


def test_float32_newton_krylov_fails_in_both_packages():
    p = held_suarez_pair(0, dtype=np.float32, winds=False)
    cfg_j, aux0 = p["cfg_j"], jnp.asarray(p["aux0"])
    vdg_j = JaxDGModel(cfg_j.model, cfg_j.grid, direction=VERTICAL,
                       update_aux=False)
    alpha = 0.5 * 0.1 * jax_min_node_distance(cfg_j.grid,
                                              "horizontal") / 350.0
    rhs_j = jnp.asarray(p["q"])
    Fj = jax.jit(lambda x: x - alpha * vdg_j(x, aux0, 0.0)[0] - rhs_j)
    start = float(jnp.linalg.norm(Fj(rhs_j)))
    _, rj = jiterative.newton_krylov(Fj, rhs_j, **NEWTON)
    ratios = {}
    for dtype in (torch.float32, torch.float64):
        grid = grid_from_numpy(grid_to_numpy(cfg_j.grid), device="cpu",
                               dtype=dtype)
        vdg = DGModel(p["cfg_t"].model, grid, direction="vertical",
                      update_aux=False)
        qt, auxt = p["qt"].to(dtype), p["auxt"].to(dtype)

        def F(x, vdg=vdg, auxt=auxt, qt=qt):
            return x - alpha * vdg(x, auxt, 0.0)[0] - qt

        _, r = newton_krylov(F, qt, **NEWTON)
        ratios[dtype] = float(r) / float(torch.linalg.vector_norm(F(qt)))
    assert float(rj) / start > 0.5, (float(rj), start)
    assert ratios[torch.float32] > 0.5, ratios
    assert ratios[torch.float64] < 0.05, ratios
