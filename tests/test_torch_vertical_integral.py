"""The Julia vertical_integral tables (tests/test_split_explicit_refvals.py
:296-343) in the port, float64 on the CPU: the indefinite column
integral of the analytic 3-D spindown velocity against the analytic
barotropic state on the periodic 5 × 5 × 8 box at p4, each statistic at
the table's 12 digits, and the analytic states against the JAX
package's at the times where its ``expm`` is finite and within 1e-12 of
the exact value (up to 30 days).

The year and decade tables are left out: each is further from the
exact exp(M t) of its own matrix (1.2e-11 and 9e-11 relative, 60-digit
mpmath) than its 12-digit gate allows, and the JAX package's ``expm``
gives NaN there, which its ``check_parr`` lets pass (ROADMAP, reference
caveats).
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.mesh.grid import make_grid as jax_make_grid
from climatemachine_tpu.mesh.topology import \
    stacked_brick_topology as jax_stacked_brick_topology
from climatemachine_tpu.ocean import hydrostatic_boussinesq as jhb
from climatemachine_tpu.ocean import problems as jpr
from climatemachine_tpu_torch.dg.columns import ColumnOps
from climatemachine_tpu_torch.dg.spatial import init_state_auxiliary
from climatemachine_tpu_torch.mesh.grid import make_grid
from climatemachine_tpu_torch.mesh.topology import (brick_topology,
                                                    stacked_brick_topology)
from climatemachine_tpu_torch.ocean import hydrostatic_boussinesq as phb
from climatemachine_tpu_torch.ocean import problems as ppr
from climatemachine_tpu_torch.ocean.shallow_water import (ConstantViscosity,
                                                          ShallowWaterModel)

L, H = 1e6, 400.0
TABLES = {"initial": 0.0, "day": 86400.0, "month": 30 * 86400.0,
          "century": 36500 * 86400.0}
HB_KW = dict(c_h=1.0, alpha_T=0.0, kappa_h=0.0, kappa_z=0.0,
             momentum_advection=None, tracer_advection=None)
RANGES = [np.linspace(0.0, L, 6), np.linspace(0.0, L, 6)]
VERTICAL = np.linspace(-H, 0.0, 9)
BOUNDARY = np.array([[0, 0], [0, 0], [1, 2]])


def load_table():
    path = pathlib.Path(__file__).parent / "refvals" / "vertical_integral.py"
    spec = importlib.util.spec_from_file_location("vertical_integral", path)
    rv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rv)
    return rv


@pytest.fixture(scope="module")
def box():
    problem = ppr.SimpleBox(L, L, H, rotation=ppr.Fixed())
    m3 = phb.HydrostaticBoussinesqModel(problem, **HB_KW)
    m2 = ShallowWaterModel(problem, turbulence=ConstantViscosity(m3.nu_h),
                           advection=None, c=1.0)
    g2 = make_grid(brick_topology(RANGES, periodicity=(True, True)), 4,
                   dtype=torch.float64, device="cpu")
    g3 = make_grid(stacked_brick_topology(
        RANGES + [VERTICAL], periodicity=(True, True, False),
        boundary=BOUNDARY), 4, dtype=torch.float64, device="cpu")
    return dict(problem=problem, m3=m3, m2=m2, g3=g3, g2=g2,
                aux3=init_state_auxiliary(m3, g3),
                aux2=init_state_auxiliary(m2, g2), rv=load_table())


def stats(x):
    a = x.numpy()
    return [a.min(), a.max(), a.mean(), a.std(ddof=1)]


@pytest.mark.parametrize("table", list(TABLES))
def test_vertical_integral_table(box, table):
    t = TABLES[table]
    b = box
    q3 = b["problem"].init_state(b["m3"], b["g3"].coords.transpose(1, 2),
                                 b["aux3"], t)
    q2 = b["problem"].sw_init_state(b["m2"], b["g2"].coords.transpose(1, 2),
                                    b["aux2"], t)
    int_u = ColumnOps(b["g3"]).indefinite_integral(b["m3"].prog(q3, "u"))
    got = {("∫u", "∫x[1]"): stats(int_u[:, 0]),
           ("∫u", "∫x[2]"): stats(int_u[:, 1]),
           ("U", "η"): stats(b["m2"].prog(q2, "eta")),
           ("U", "U[1]"): stats(b["m2"].prog(q2, "U")[:, 0]),
           ("U", "U[2]"): stats(b["m2"].prog(q2, "U")[:, 1])}
    ref, parr = getattr(b["rv"], table), b["rv"].parr
    failures = []
    for key, row in ref.items():
        for g, r, d in zip(got[key], row, parr[key]):
            if d == 0:
                continue
            ok = (abs(g) <= 10.0 ** -d if r == 0.0
                  else abs(g - r) <= 5.0 * 10.0 ** -d * abs(r))
            if not ok:
                failures.append((key, g, r, d))
    assert not failures


@pytest.mark.parametrize("t", [3600.0, 86400.0, 30 * 86400.0])
def test_hb_state_against_jax(box, t):
    """The barotropic transport and height against the JAX ``hb_state``
    on the same nodes, 1e-11 relative (the JAX ``expm`` is 6e-13 off the
    exact value at 30 days, the port's closed form 3e-14)."""
    b = box
    pj = jpr.SimpleBox(L, L, H, rotation=jpr.Fixed())
    mj = jhb.HydrostaticBoussinesqModel(pj, **HB_KW)
    gj = jax_make_grid(jax_stacked_brick_topology(
        RANGES + [VERTICAL], periodicity=(True, True, False),
        boundary=BOUNDARY), 4, dtype=np.float64)
    ref = pj.hb_state(mj, jnp.asarray(gj.coords), t)
    got = b["problem"].hb_state(b["m3"], b["g3"].coords.transpose(1, 2), t)
    for g, r in zip(got[:3], ref[:3]):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-11 * max(np.abs(r).max(),
                                                          1e-300)
