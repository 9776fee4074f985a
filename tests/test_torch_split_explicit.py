"""The split-explicit ocean in the port against the JAX package's, in
float64 on the CPU: the gyre (OceanGyre) on tests/ocean_parity.py's 3 ×
2 × 3 box at p3 (nx ≠ ny) with ``CoupledHBModel(c_h=1, kappa_c=0.1)``,
and ``BarotropicModel(ConstantViscosity(ν_h), advection=None, c=1)``
with the central flux on the walled 3 × 2 brick of the same horizontal
ranges, from the initial state plus noise (numpy seeds):

- the coupled model's RHS and the aux it returns (w, pkin with g, wz0,
  uᵈ), and ``init_ode_state``'s uᵈ, within 1e-11 per variable, as built
  and with "nonlinear" momentum advection and ``num_impl_steps`` = 5
  (the explicit κᶻ/2);
- the column total in the 2-D layout and the broadcast down the
  columns against the JAX solver's ``_col_total_2d`` and ``_to_3d``;
- 2 slow steps of ``SplitExplicitSolver`` ("new"; LSRK54 slow at 600 s,
  LSRK54 fast at 120 s: 1-2 fast steps a stage), coupled and uncoupled
  (HydrostaticBoussinesqModel with ShallowWaterModel), and 1 slow step of
  ``SplitExplicitSolverType().make`` (LS3NRK33Heuns fast), each state
  and aux within 1e-10 per variable;
- the variants "split01" and "split01_3n" built (their parity:
  tests/test_torch_split01.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.numerical_fluxes import \
    CentralNumericalFluxFirstOrder as JaxCentral
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import init_ode_state as jax_init
from climatemachine_tpu.dg.spatial import \
    init_state_auxiliary as jax_init_aux
from climatemachine_tpu.driver.solver_types import \
    SplitExplicitSolverType as JaxSEType
from climatemachine_tpu.ocean import hydrostatic_boussinesq as jhb
from climatemachine_tpu.ocean import shallow_water as jsw
from climatemachine_tpu.ocean import split_explicit as jse
from climatemachine_tpu.ode import lsrk as jlsrk
from climatemachine_tpu_torch.dg.numerical_fluxes import \
    CentralNumericalFluxFirstOrder
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.driver.solver_types import \
    SplitExplicitSolverType
from climatemachine_tpu_torch.ocean import hydrostatic_boussinesq as phb
from climatemachine_tpu_torch.ocean import ivdc as pivdc
from climatemachine_tpu_torch.ocean import shallow_water as psw
from climatemachine_tpu_torch.ocean import split_explicit as pse
from climatemachine_tpu_torch.ode import lsrk
from ocean_parity import grids, nm, perturbed, rel_err_per_var, vm
from split_explicit_parity import Jitted, grids2, noisy, problems

TOL = 1e-11
STEP_TOL = 1e-10
DT, DT_FAST = 600.0, 120.0
AUX = ("w", "pkin", "wz0", "ud")


def models(coupled=True, **kw):
    """((JAX 3-D, 2-D), (port 3-D, 2-D)) of the gyre."""
    pj, pt = problems("gyre")
    out = []
    for p, hb, sw, se in ((pj, jhb, jsw, jse), (pt, phb, psw, pse)):
        m3 = (se.CoupledHBModel(p, c_h=1.0, kappa_c=0.1, **kw) if coupled
              else hb.HydrostaticBoussinesqModel(p, c_h=1.0, kappa_c=0.1,
                                                 **kw))
        cls = se.BarotropicModel if coupled else sw.ShallowWaterModel
        out.append((m3, cls(p, turbulence=sw.ConstantViscosity(m3.nu_h),
                            advection=None, c=1.0)))
    return out


def setup(coupled=True, seed=0, **kw):
    """Both packages' operators and a noisy state pair: dict with the
    JAX jitted operators ``d3j``, ``d2j`` and state ``qj``, ``aj``
    (pairs), the port's ``d3``, ``d2``, ``q``, ``aux``."""
    (m3j, m2j), (m3t, m2t) = models(coupled, **kw)
    g3j, g3t = grids()
    g2j, g2t = grids2(periodic=False)
    dj3 = JaxDGModel(m3j, g3j)
    m3j._cols(g3j)
    m3j._vert_filters(g3j)
    dj2 = JaxDGModel(m2j, g2j, numerical_flux_first_order=JaxCentral())
    d3 = DGModel(m3t, g3t)
    d2 = DGModel(m2t, g2t,
                 numerical_flux_first_order=CentralNumericalFluxFirstOrder())
    q3j, a3j = jax_init(dj3)
    q3 = perturbed(q3j, seed)
    a3 = np.asarray(a3j)
    a2 = np.array(jax_init_aux(m2j, g2j))
    q2 = noisy(np.zeros(a2.shape[:-1] + (3,)), [0.01, 1.0, 1.0], seed + 1)
    return dict(d3j=Jitted(dj3), d2j=Jitted(dj2), d3=d3, d2=d2,
                m3j=m3j, m3t=m3t, init=(q3j, a3j, g3t),
                qj=(jnp.asarray(q3), jnp.asarray(q2)),
                aj=(jnp.asarray(a3), jnp.asarray(a2)),
                q=(vm(q3), vm(q2)), aux=(vm(a3), vm(a2)))


def assert_pairs_close(got_q, got_aux, ref_q, ref_aux, tol=STEP_TOL):
    for got, ref in zip(got_q + got_aux, ref_q + ref_aux):
        assert max(rel_err_per_var(nm(got), ref)) < tol


@pytest.fixture(scope="module")
def coupled():
    return setup(True, seed=0)


@pytest.mark.parametrize("kw", [None, dict(momentum_advection="nonlinear",
                                           num_impl_steps=5)],
                         ids=["default", "advection_impl_steps"])
def test_coupled_rhs_and_aux(kw, coupled):
    s = coupled if kw is None else setup(True, seed=3, **kw)
    tj, aj = s["d3j"](s["qj"][0], s["aj"][0], 0.0)
    tt, at = s["d3"](s["q"][0], s["aux"][0], 0.0)
    assert max(rel_err_per_var(nm(tt), tj)) < TOL
    m = s["m3t"]
    for name in AUX:
        sl = m.aux_spec.index(name)
        assert max(rel_err_per_var(nm(at)[..., sl],
                                   np.asarray(aj)[..., sl])) < TOL, name


def test_init_ode_state_flow_deviation(coupled):
    """init_ode_state hands the grid to the coupled model's aux refresh:
    uᵈ of the initial state as the JAX package's."""
    q3j, a3j, g3t = coupled["init"]
    q0, a0 = init_ode_state(coupled["d3"])
    assert max(rel_err_per_var(nm(q0), q3j)) < 1e-14
    assert max(rel_err_per_var(nm(a0), a3j)) < 1e-14
    # a state with flow: uᵈ = u − ∫u dz / H has no column mean
    q = coupled["q"][0]
    aux = pse.CoupledHBModel.update_auxiliary_state(
        coupled["m3t"], q, a0, g3t)
    ud = coupled["m3t"].aux_get(aux, "ud")
    cols = coupled["m3t"]._cols(g3t)
    assert cols.column_total_2d(ud).abs().max() < 1e-10 * cols.\
        column_total_2d(coupled["m3t"].prog(q, "u")).abs().max()


def test_column_layouts(coupled):
    """The column total in the 2-D layout and the broadcast down the
    columns, against the JAX solver's reshapes, on the nx ≠ ny box."""
    sj = jse.SplitExplicitSolver(
        jlsrk.LSRK54CarpenterKennedy(None, DT),
        jlsrk.LSRK54CarpenterKennedy(None, DT_FAST), coupled["d3j"],
        coupled["d2j"], dt=DT, fast_dt=DT_FAST)
    cols = pse.ColumnOps(coupled["d3"].grid)
    f3 = noisy(np.zeros(np.shape(coupled["qj"][0])[:-1] + (2,)), [1.0, 2.0],
               7)
    tot_j = sj._col_total_2d(jnp.asarray(f3))
    tot_t = cols.column_total_2d(vm(f3))
    assert tot_t.shape == (6, 2, 16)
    assert max(rel_err_per_var(nm(tot_t), tot_j)) < 1e-14
    f2 = noisy(np.zeros((6, 16, 2)), [1.0, 2.0], 8)
    assert np.abs(nm(cols.broadcast_2d(vm(f2)))
                  - np.asarray(sj._to_3d(jnp.asarray(f2)))).max() == 0.0


def _jax_solver(s, coupled=True):
    return jse.SplitExplicitSolver(
        jlsrk.LSRK54CarpenterKennedy(s["d3j"], DT),
        jlsrk.LSRK54CarpenterKennedy(s["d2j"], DT_FAST),
        s["d3j"], s["d2j"], dt=DT, fast_dt=DT_FAST, coupled=coupled)


@pytest.mark.parametrize("coupled_run", [True, False],
                         ids=["coupled", "uncoupled"])
def test_new_variant_two_steps(coupled_run, coupled):
    s = coupled if coupled_run else setup(False, seed=0)
    sj = _jax_solver(s, coupled=coupled_run)
    st = pse.SplitExplicitSolver(
        lsrk.LSRK54CarpenterKennedy(s["d3"], DT),
        lsrk.LSRK54CarpenterKennedy(s["d2"], DT_FAST), s["d3"], s["d2"],
        dt=DT, fast_dt=DT_FAST, coupled=coupled_run)
    assert st.fast_steps() == [1, 2, 2, 2, 1]
    qj, aj, q, aux = s["qj"], s["aj"], s["q"], s["aux"]
    for i in range(2):
        qj, aj = sj.step(qj, aj, i * DT)
        q, aux = st.step(q, aux, i * DT)
    assert_pairs_close(q, aux, qj, aj)
    assert all(bool(torch.isfinite(x).all()) for x in q)


def test_solver_type_heuns_fast(coupled):
    """SplitExplicitSolverType().make: LSRK54 slow with the filters,
    LS3NRK33Heuns fast, one slow step."""
    s = coupled
    sj = JaxSEType(dt_slow=DT, dt_fast=DT_FAST).make(s["d3j"], s["d2j"])
    st = SplitExplicitSolverType(dt_slow=DT, dt_fast=DT_FAST).make(
        s["d3"], s["d2"])
    assert type(st.fast).__name__ == "ExplicitRungeKutta"
    assert st.fast.nstages == 3 and st.vm is None
    qj, aj = sj.step(s["qj"], s["aj"], 0.0)
    q, aux = st.step(s["q"], s["aux"], 0.0)
    assert_pairs_close(q, aux, qj, aj)


@pytest.mark.parametrize("variant", ["split01", "split01_3n"])
def test_split01_variants_next_slice(variant, coupled):
    """The split01 variants are ported (tests/test_torch_split01.py holds
    them against the JAX package's): the solver builds them; another
    variant is a ValueError."""
    s = coupled
    st = pse.SplitExplicitSolver(
        lsrk.LSRK54CarpenterKennedy(s["d3"], DT),
        lsrk.LSRK54CarpenterKennedy(s["d2"], DT_FAST), s["d3"], s["d2"],
        variant=variant)
    assert st.variant == variant and st.ivdc_residuals == []
    with pytest.raises(ValueError):
        pse.SplitExplicitSolver(None, None, s["d3"], s["d2"], dt=DT,
                                fast_dt=DT_FAST, variant="old")


def test_experiment_ivdc_schedule():
    """The experiment's 3-D model carries the IVDC schedule (5 solves at
    dt/5, as the Julia simple_box_ivd configuration,
    tests/test_simple_box_ivd_refvals.py:55-56), so that its explicit
    vertical diffusivity is κᶻ/2 without the convective branch; a solve
    on the initial state of a 2 × 2 × 2 box converges."""
    from climatemachine_tpu_torch.experiments import ocean_split_explicit
    cfg = ocean_split_explicit.make(2, 2, device="cpu")
    m3 = cfg.m3
    assert (m3.num_impl_steps, m3.ivdc_dt) == (5, 1080.0)
    E, L = 2, 3
    grad = torch.zeros((E, 3, 5, L), dtype=torch.float64)
    grad[:, 2, 4] = -1.0                       # ∂θ/∂z < 0: unstable
    gf = m3.compute_gradient_flux(grad, torch.zeros((E, 4, L)), None, 0.0)
    k = gf[:, m3.gf_spec.index("kappa_grad_theta")]
    assert torch.equal(k[:, 2], torch.full((E, L), 0.5 * m3.kappa_z,
                                           dtype=torch.float64))
    q3, res = pivdc.ivdc_solve(m3, cfg.dg3, cfg.q[0], cfg.aux[0],
                               m3.ivdc_dt)
    assert float(res) < 1e-12 and bool(torch.isfinite(q3).all())
