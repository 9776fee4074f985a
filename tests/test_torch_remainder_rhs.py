"""The port's var-major RHS on a fused remainder
(``VarMajorRHS(remainder_DGModel(dg, dg_lin))``) against the JAX
package's, in float64 on the CPU, on dry Held-Suarez with
DryBiharmonic(8 h) at n_horz=2, n_vert=2, p3 on the JAX grid's arrays,
from the initial state times 1 + 1e-3·N(0, 1) (numpy, seed 5):

- for each linear model (acoustic-gravity, acoustic) and direction
  ("vertical", "every"), each of the port's surface passes against JAX
  ``VarMajorRHS(dg_rem)`` with the "xla" surface pass: per variable
  1e-11 of its largest magnitude, the tests/test_fast_rhs.py:76
  precedent ("hybrid" and "pallas" run the surface kernels' plain
  versions, which JAX holds against its "xla" pass the same way,
  tests/test_fast_rhs.py:181-216);
- the port's var-major remainder against its generic remainder
  ``dg_rem(q, aux)`` and against the two-call difference ``dg(q) −
  dg_lin(q)``: 1e-11 likewise.
"""

import numpy as np
import pytest

from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu_torch.dg.fast_rhs import SURFACE_KERNELS
from climatemachine_tpu_torch.experiments.held_suarez import \
    held_suarez_config
from remainder_parity import (CASES, IDS, RHS_TOL, build, port_remainder,
                              port_rhs, rel_err_per_var)


def _perturb(q0):
    rng = np.random.default_rng(5)
    return q0 * (1 + 1e-3 * rng.standard_normal(q0.shape))


@pytest.fixture(scope="module")
def setup():
    return build(jax_held_suarez_config, held_suarez_config, _perturb)


@pytest.mark.parametrize("mode", SURFACE_KERNELS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_remainder_rhs_matches_jax(setup, case, mode):
    got = port_rhs(setup, case, mode, write_aux=False)
    err = rel_err_per_var(got, setup["refs"][case])
    assert got.shape[1] == 5 and err.max() < RHS_TOL, err


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_remainder_rhs_matches_generic_remainder(setup, case):
    dg_rem = port_remainder(setup["dg_t"], case)
    q, aux = setup["qv"], setup["auxv"]
    got = port_rhs(setup, case, "xla")
    assert rel_err_per_var(got, dg_rem(q, aux, 0.0)[0]).max() < RHS_TOL
    lin, ldir = dg_rem.remainder
    dg_lin = type(setup["dg_t"])(lin, dg_rem.grid, direction=ldir,
                                 update_aux=False)
    diff = setup["dg_t"](q, aux, 0.0)[0] - dg_lin(q, aux, 0.0)[0]
    assert rel_err_per_var(got, diff).max() < RHS_TOL
