"""The port's var-major RHS on a fused remainder of the moist baroclinic
wave (EquilMoist, EquilMoistBiharmonic(8 h), Gravity, Coriolis) against
the JAX package's, in float64 on the CPU at n_horz=2, n_vert=2, p3 on
the JAX grid's arrays, from the initial state times 1 + 1e-3·N(0, 1)
with ρq_tot raised to supersaturation on a third of the nodes (numpy,
seed 19; the state of tests/test_torch_moist_rhs.py):

- for each linear model (acoustic-gravity, acoustic) and direction
  ("vertical", "every"), each of the port's surface passes against JAX
  ``VarMajorRHS(dg_rem)`` with the "xla" surface pass: per variable
  1e-11 of its largest magnitude (tests/test_fast_rhs.py:76).  The
  linear models carry no ρq_tot flux, but the linear Rusanov flux's
  jump term still acts on ρq_tot on the linear faces, as in the JAX
  package;
- the moisture aux lanes the remainder writes equal the full RHS's.
"""

import pytest
import torch

from climatemachine_tpu.experiments.baroclinic_wave import \
    baroclinic_wave_config as jax_baroclinic_wave_config
from climatemachine_tpu_torch.dg.fast_rhs import SURFACE_KERNELS, VarMajorRHS
from climatemachine_tpu_torch.experiments.baroclinic_wave import \
    baroclinic_wave_config
from remainder_parity import (CASES, IDS, RHS_TOL, build, port_remainder,
                              port_rhs, rel_err_per_var)
from test_torch_moist_rhs import moist_test_state


@pytest.fixture(scope="module")
def setup():
    return build(jax_baroclinic_wave_config, baroclinic_wave_config,
                 lambda q0: moist_test_state(q0, 19))


@pytest.mark.parametrize("mode", SURFACE_KERNELS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_moist_remainder_rhs_matches_jax(setup, case, mode):
    got = port_rhs(setup, case, mode)
    err = rel_err_per_var(got, setup["refs"][case])
    assert got.shape[1] == 6 and err.max() < RHS_TOL, err


def test_moist_remainder_writes_the_full_rhs_aux(setup):
    q, aux = setup["qv"], setup["auxv"]
    _, aux_full = VarMajorRHS(setup["dg_t"])(q, aux, 0.0)
    _, aux_rem = VarMajorRHS(port_remainder(setup["dg_t"], CASES[0]))(
        q, aux, 0.0)
    assert torch.equal(aux_rem, aux_full) and not torch.equal(aux_rem, aux)
