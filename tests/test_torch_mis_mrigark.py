"""The port's ``MISSolverType`` and MRI-GARK steps on the Held-Suarez
slow/fast split against the JAX package's, in float64 on the CPU at
n_horz=2, n_vert=3, p3 with DryBiharmonic(8 h), from a seeded
perturbation of the initial state with seeded winds of 1 m/s
(tests/numerics_parity.py), at 4 × the explicit dt
(tests/test_imex.py:206-229):

- one step of MIS2, MIS3C and MISRK3, each with LSRK54 and with
  SSPRK33ShuOsher fast steps (4 substeps a unit stage), through
  ``MISSolverType(...).make`` against the JAX type's: 1e-10 of each
  variable's max|q|;
- one step of MRIGARKERK33aSandu and MRIGARKERK45aSandu on the same
  slow operator (the fused remainder ``remainder_DGModel(dg, dg_fast)``)
  and fast one (the acoustic-gravity linear model in every direction),
  LSRK54 fast steps: 1e-10;
- the slow operator's evaluations a step, counted on the CPU (what
  chip_smoke.py predicts for the dry volume kernel's remainder branch and
  the chain kernels): nstages − 1 for MIS, nstages for MRI-GARK.

The JAX solvers step eagerly around the two DG operators, each compiled
once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.driver.solver_types import \
    MISSolverType as JaxMISSolverType
from climatemachine_tpu.mesh.grid import \
    min_node_distance as jax_min_node_distance
from climatemachine_tpu.ode import mis as jmis
from climatemachine_tpu.ode import mrigark as jmri
from climatemachine_tpu.ode import ssprk as jssprk
from climatemachine_tpu.ode.lsrk import LSRK54CarpenterKennedy as JaxLSRK54
from climatemachine_tpu_torch.driver.solver_types import MISSolverType
from climatemachine_tpu_torch.interop import to_var_major
from climatemachine_tpu_torch.ode import mis, mrigark, ssprk
from climatemachine_tpu_torch.ode.lsrk import LSRK54CarpenterKennedy
from numerics_parity import held_suarez_pair, one_torch_thread  # noqa: F401

NSUB = 4
MIS = {"MIS2": 4, "MIS3C": 4, "MISRK3": 4}
MRI = {"MRIGARKERK33aSandu": 3, "MRIGARKERK45aSandu": 5}
FAST = {"LSRK54": (JaxLSRK54, LSRK54CarpenterKennedy),
        "SSPRK33": (jssprk.SSPRK33ShuOsher, ssprk.SSPRK33ShuOsher)}
TOL = 1e-10


@pytest.fixture(scope="module")
def s():
    p = held_suarez_pair(41)
    dt = 4 * 0.3 * jax_min_node_distance(p["cfg_j"].grid) / 350.0
    base = JaxMISSolverType(nsubsteps=NSUB).make(p["dg_j"], p["q0"],
                                                 p["aux0"], dt)
    return dict(p, dt=dt, q=jnp.asarray(p["q"]),
                slow_j=jax.jit(base.slow_rhs), fast_j=jax.jit(base.fast_rhs))


def _rel_per_var(got, ref_node_major):
    ref = to_var_major(np.asarray(ref_node_major), "cpu").numpy()
    return (np.abs(got.numpy() - ref).max(axis=(0, 2))
            / np.abs(ref).max(axis=(0, 2)))


def _port_mis(s, name, fast):
    return MISSolverType(mis_method=getattr(mis, name),
                         fast_method=FAST[fast][1], nsubsteps=NSUB).make(
        s["dg_t"], s["q0_t"], s["aux0_t"], s["dt"])


@pytest.mark.parametrize("fast", list(FAST))
@pytest.mark.parametrize("name", list(MIS))
def test_mis_step_matches_jax(s, name, fast):
    jf = FAST[fast][0]
    ref, _ = getattr(jmis, name)(s["slow_j"], s["fast_j"],
                                 lambda rhs, d: jf(rhs, d), nsubsteps=NSUB,
                                 dt=s["dt"]).step(s["q"], s["aux0"], 0.0)
    sol = _port_mis(s, name, fast)
    assert sol.vm is None and sol.nstages == MIS[name]
    got, _ = sol.step(s["qt"], s["auxt"], 0.0)
    err = _rel_per_var(got, ref)
    assert err.max() < TOL, err


@pytest.mark.parametrize("name", list(MRI))
def test_mrigark_step_matches_jax(s, name):
    ref, _ = getattr(jmri, name)(
        s["slow_j"], s["fast_j"], lambda rhs, d: JaxLSRK54(rhs, d), NSUB,
        s["dt"]).step(s["q"], s["aux0"], 0.0)
    split = _port_mis(s, "MIS2", "LSRK54")
    sol = getattr(mrigark, name)(
        split.slow_rhs, split.fast_rhs,
        lambda rhs, d: LSRK54CarpenterKennedy(rhs, d), NSUB, s["dt"])
    assert split.slow_rhs.remainder is not None
    assert split.fast_rhs.direction == "every"
    got, _ = sol.step(s["qt"], s["auxt"], 0.0)
    err = _rel_per_var(got, ref)
    assert err.max() < TOL, err


@pytest.mark.parametrize("name", list(MIS) + list(MRI))
def test_slow_evaluations_per_step(s, name):
    split = _port_mis(s, name if name in MIS else "MIS2", "SSPRK33")
    calls = []
    slow = split.slow_rhs

    def counted(q, aux, t):
        calls.append(t)
        return slow(q, aux, t)

    if name in MIS:
        split.slow_rhs = counted
        sol = split
    else:
        sol = getattr(mrigark, name)(
            counted, split.fast_rhs,
            lambda rhs, d: ssprk.SSPRK33ShuOsher(rhs, d), NSUB, s["dt"])
    sol.step(s["qt"], s["auxt"], 0.0)
    assert len(calls) == (MIS[name] - 1 if name in MIS else MRI[name])
