"""The port's var-major surface kernels (climatemachine_tpu_torch.dg
.surface_kernel) and the surface passes of its VarMajorRHS against the
JAX package, in float64 on the CPU:

- kernel level: the plain versions and the CPU wrappers against JAX
  ``extract_trace_vm`` / ``fused_surface_lift_vm`` run in interpret mode,
  on seeded numpy inputs, within 1e-12 relative per output lane: the main
  path with hyperdiffusion on and off, nq=6 with ngl=5, subtract=False
  (no aux lane) and the fused remainder's linear-flux lanes on the
  vertical faces with and without gravity in the linear model;
- RHS level, at n_horz=2, n_vert=2, p3 with hyperdiffusion off and on:
  the surface pass of ``VarMajorRHS`` with ``surface_kernel`` "hybrid"
  and "pallas" against the JAX ``VarMajorRHS``'s with the same attribute,
  both fed the same state, thermo and ∇Δ; and the port's whole RHS in
  each mode against its own "xla" one; 1e-11 relative per variable
  (tests/test_fast_rhs.py:213).  The rest of the RHS is held against the
  JAX package by tests/test_torch_held_suarez.py, which also holds a step
  of ``ExplicitSolverType`` against the JAX one;
- the CUDA wrappers refuse what their kernels do not cover, and the
  explicit entry point what is not ported.

The JAX kernels' shapes and static arguments at the main cases are those
of the JAX RHS's surface pass on this grid, so each compiles once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.dg.fast_rhs import VarMajorRHS as JaxVarMajorRHS
from climatemachine_tpu.dg.pallas_surface import \
    extract_trace_vm as jax_extract_trace_vm
from climatemachine_tpu.dg.pallas_surface import \
    fused_surface_lift_vm as jax_fused_surface_lift_vm
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.experiments.held_suarez import \
    held_suarez_config as jax_held_suarez_config
from climatemachine_tpu_torch.dg import surface_kernel
from climatemachine_tpu_torch.dg.fast_rhs import VarMajorRHS
from climatemachine_tpu_torch.dg.spatial import DGModel, init_ode_state
from climatemachine_tpu_torch.driver.solver_types import ExplicitSolverType
from climatemachine_tpu_torch.experiments.held_suarez import \
    held_suarez_config
from climatemachine_tpu_torch.interop import grid_from_numpy, grid_to_numpy
from climatemachine_tpu_torch.physics.parameters import EARTH

SIZE = dict(n_horz=2, n_vert=2, poly_order=3)
NQ1, E, NFACE = 4, 48, 6            # the grid of SIZE: Nq, elements
NP, NFP = NQ1 ** 3, NQ1 ** 2
X = NFACE * NFP
BLOCK_E = 16                         # the JAX RHS's block at E = 48
R_D_T0 = EARTH.R_d * EARTH.T_0
R_OVER_CV = EARTH.R_d / EARTH.cv_d
MODES = ("hybrid", "pallas")             # the kernel surface passes

# name: (nq, ngl, has_hyper, subtract, remainder, lin_gravity)
CASES = {
    "main_hyper": (5, 4, True, True, False, True),
    "main_no_hyper": (5, 1, False, True, False, True),
    "moist_nq6": (6, 5, True, True, False, True),
    "no_subtract": (5, 4, True, False, False, True),
    "remainder_gravity": (5, 4, True, True, True, True),
    "remainder_acoustic": (5, 4, True, True, True, False),
}


def _hex_lift():
    """The 0/1 face-extraction matrix of a hexahedron of NQ1³ nodes
    (x fastest), faces -x, +x, -y, +y, -z, +z: [NP, X]."""
    idx = np.arange(NP).reshape(NQ1, NQ1, NQ1)        # [z, y, x]
    faces = [idx[:, :, 0], idx[:, :, -1], idx[:, 0, :], idx[:, -1, :],
             idx[0], idx[-1]]
    lift = np.zeros((NP, X))
    for f, nodes in enumerate(faces):
        lift[nodes.reshape(-1), f * NFP + np.arange(NFP)] = 1.0
    return lift


def _kernel_inputs(nq, ngl, has_hyper, subtract, remainder, lin_gravity,
                   seed):
    """Physically scaled random volume fields (ρ ~ 1, |u| <= 50, p ~ 1e5,
    ∇Δ ~ 1e-12, ν ~ 1e14), unit normals and the aux lanes the JAX RHS
    builds (_aux_lanes: p_ref, then φ, the energy coefficient and the
    linear sound speed for a remainder): (extract args, extract statics,
    lift geometry, lift statics)."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.1 * rng.standard_normal((E, NP))
    u = rng.uniform(-50.0, 50.0, (E, 3, NP))
    rhoe = rho * (2.5e5 + 1e4 * rng.standard_normal((E, NP)))
    extra = [rho[:, None] * 1e-3 * rng.uniform(0, 5, (E, 1, NP))] * (nq - 5)
    qv = np.concatenate([rho[:, None], rho[:, None] * u, rhoe[:, None]]
                        + extra, axis=1)
    p = 1e5 * (1 + 0.05 * rng.standard_normal((E, NP)))
    c_s = 340.0 + 5.0 * rng.standard_normal((E, NP))
    aux = []
    if subtract or remainder:
        aux.append(p * (1 + 1e-3 * rng.standard_normal((E, NP))))
    if remainder:
        phi = 9.81 * rng.uniform(0, 3e4, (E, NP))
        rho_ref = rho * (1 + 1e-2 * rng.standard_normal((E, NP)))
        coeff = (2.5e5 * rho_ref + aux[0]) / rho_ref
        if not lin_gravity:
            coeff = coeff - phi
        T_ref = 250.0 + 20.0 * rng.uniform(size=(E, NP))
        cl = np.sqrt(EARTH.cp_d / EARTH.cv_d * EARTH.R_d * T_ref)
        aux += [phi, coeff, cl]
    na = len(aux)
    aux4 = np.stack(aux, axis=1) if na else np.zeros((E, 1, NP))
    if has_hyper:
        gl2k = 1e-12 * rng.standard_normal((E, 3 * ngl, NP))
        nu = 1e14 * rng.uniform(0.5, 1.5, (E, 2, NP))
    else:
        gl2k, nu = np.zeros((E, 3, NP)), np.zeros((E, 2, NP))
    nrm = rng.standard_normal((E, 3, X))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    lift = _hex_lift()
    ext_args = (qv, p, c_s, aux4, gl2k, nu, lift, nrm)
    ext_kw = dict(nq=nq, na=na, ngl=ngl, has_hyper=has_hyper)

    nvb0 = nq + 2 + na
    bmask = np.repeat(rng.integers(0, 2, (E, 1, NFACE)), NFP,
                      axis=2).astype(np.float64)
    sM = rng.uniform(1e9, 2e9, (E, 1, X))
    MI = 1.0 / rng.uniform(1e9, 2e9, (E, NP))
    lift_kw = dict(
        nq=nq, nvb=nvb0 + (nq if has_hyper else 0), subtract=subtract,
        i_pref=nq + 2 if (subtract or remainder) else nq,
        has_hyper=has_hyper,
        rem_lanes=(nvb0 - 3, nvb0 - 2, nvb0 - 1) if remainder else (),
        sl_lo=4 * NFP if remainder else 0, sl_hi=6 * NFP if remainder else 0,
        R_d_T0=R_D_T0, R_over_cv=R_OVER_CV)
    geometry = (nrm, sM, bmask, lift.T.copy(), MI)
    return ext_args, ext_kw, geometry, lift_kw, rng


def _rel_err_per_lane(got, ref):
    """max |got − ref| per lane (axis 1) over elements and nodes, relative
    to max |ref| of that lane."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.maximum(np.max(np.abs(ref), axis=(0, 2)), 1e-300)
    return np.max(np.abs(got - ref), axis=(0, 2)) / scale


@pytest.mark.parametrize("case", list(CASES))
def test_surface_kernels_match_jax(case):
    ext_args, ext_kw, geometry, lift_kw, rng = _kernel_inputs(
        *CASES[case], seed=len(case))
    t = lambda arrays: [torch.as_tensor(a) for a in arrays]

    Bf_ref = np.array(jax_extract_trace_vm(
        *(jnp.asarray(a) for a in ext_args), block_e=BLOCK_E,
        interpret=True, **ext_kw))
    Bf = surface_kernel.extract_trace_plain(*t(ext_args), **ext_kw)
    assert Bf.shape == Bf_ref.shape == (E, lift_kw["nvb"], X)
    assert _rel_err_per_lane(Bf, Bf_ref).max() < 1e-12
    np.testing.assert_array_equal(
        surface_kernel.extract_trace_vm(*t(ext_args), **ext_kw).numpy(),
        Bf.numpy())

    # the neighbour side: other elements' bundles, slightly perturbed
    BP_np = Bf_ref[rng.permutation(E)] * (1 + 1e-3 * rng.standard_normal(
        Bf_ref.shape))
    lift_args = (Bf_ref, BP_np) + geometry
    ref = np.asarray(jax_fused_surface_lift_vm(
        *(jnp.asarray(a) for a in lift_args), block_e=BLOCK_E,
        interpret=True, **lift_kw))
    got = surface_kernel.surface_lift_plain(*t(lift_args), **lift_kw)
    assert got.shape == ref.shape == (E, lift_kw["nq"], NP)
    err = _rel_err_per_lane(got, ref)
    assert err.max() < 1e-12, err
    np.testing.assert_array_equal(
        surface_kernel.fused_surface_lift_vm(*t(lift_args),
                                             **lift_kw).numpy(),
        got.numpy())


@pytest.fixture(scope="module", params=[None, 8 * 3600.0],
                ids=["hd_off", "hd_on"])
def setup(request):
    """The JAX and the port's VarMajorRHS on the JAX grid's arrays, a
    perturbed initial state (the port's init, which
    tests/test_torch_held_suarez.py holds to JAX's) and the state's
    thermo and ∇Δ, the hyperdiffusion timescale of the parameter."""
    tau = request.param
    cfg_j = jax_held_suarez_config(dtype=np.float64, hyperdiffusion_tau=tau,
                                   **SIZE)
    cfg_t = held_suarez_config(dtype=torch.float64, hyperdiffusion_tau=tau,
                               device="cpu", **SIZE)
    grid_t = grid_from_numpy(grid_to_numpy(cfg_j.grid), device="cpu",
                             dtype=torch.float64)
    dg_t = DGModel(cfg_t.model, grid_t)
    q0, aux = init_ode_state(dg_t)
    rng = np.random.default_rng(11)
    q = q0 * torch.as_tensor(1 + 1e-3 * rng.standard_normal(q0.shape))
    rhs = VarMajorRHS(dg_t)
    _, p, c_s, _ = rhs._thermo_update(q, aux, False)
    gl2 = rhs._chain(q, aux, p) if tau else None
    return dict(tau=tau, rhs=rhs, q=q, aux=aux, p=p, c_s=c_s, gl2=gl2,
                vm_j=JaxVarMajorRHS(JaxDGModel(cfg_j.model, cfg_j.grid)))


def _jax_surfaces(setup):
    """The JAX VarMajorRHS's surface pass with surface_kernel "hybrid" and
    "pallas" on the fixture's state, thermo and ∇Δ (the port's ν), traced
    and compiled together once per fixture."""
    if "jax_surfaces" not in setup:
        rhs, vm_j, gl2 = setup["rhs"], setup["vm_j"], setup["gl2"]
        hyper = None
        if gl2 is not None:
            E, _, Np = gl2.shape
            hyper = (gl2.reshape(E, 3, 4, Np).numpy(), rhs.nu.numpy())

        def surfaces(q, aux, p, c_s, hyper):
            out = {}
            for mode in MODES:
                vm_j.surface_kernel = mode
                out[mode] = vm_j._surface(q, aux, p, c_s, 0.0, hyper=hyper)
            vm_j.surface_kernel = "xla"
            return out

        setup["jax_surfaces"] = jax.jit(surfaces)(
            *(setup[k].numpy() for k in ("q", "aux", "p", "c_s")), hyper)
    return setup["jax_surfaces"]


@pytest.mark.parametrize("mode", MODES)
def test_surface_pass_matches_jax(setup, mode):
    rhs = setup["rhs"]
    ref = _jax_surfaces(setup)[mode]
    rhs.surface_kernel = mode
    try:
        got = rhs._surface(setup["q"], setup["p"], setup["c_s"],
                           rhs._aux_lanes(setup["aux"]), setup["gl2"])
    finally:
        rhs.surface_kernel = "xla"
    err = _rel_err_per_lane(got, ref)
    assert err.max() < 1e-11, err


@pytest.mark.parametrize("mode", MODES)
def test_rhs_mode_matches_xla(setup, mode):
    rhs, q, aux = setup["rhs"], setup["q"], setup["aux"]
    ref, aux_ref = rhs(q, aux, 0.0)
    rhs.surface_kernel = mode
    try:
        got, aux_got = rhs(q, aux, 0.0)
    finally:
        rhs.surface_kernel = "xla"
    err = _rel_err_per_lane(got, ref)
    assert err.max() < 1e-11, err
    assert torch.equal(aux_got, aux_ref)


def test_unknown_surface_kernel_raises(setup):
    rhs = setup["rhs"]
    rhs.surface_kernel = "fused"
    try:
        with pytest.raises(ValueError, match="surface_kernel"):
            rhs(setup["q"], setup["aux"], 0.0)
    finally:
        rhs.surface_kernel = "xla"


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _meta_extract_args(nq=5, na=1, ngl=4, E=8, Np=64, X=96):
    return (_meta(E, nq, Np), _meta(E, Np), _meta(E, Np), _meta(E, na, Np),
            _meta(E, 3 * ngl, Np), _meta(E, 2, Np), _meta(Np, X),
            _meta(E, 3, X))


def _meta_lift_args(nvb=13, E=8, Np=64, X=96):
    return (_meta(E, nvb, X), _meta(E, nvb, X), _meta(E, 3, X),
            _meta(E, 1, X), _meta(E, 1, X), _meta(X, Np), _meta(E, Np))


LIFT_KW = dict(nq=5, nvb=13, subtract=True, i_pref=7, has_hyper=True,
               rem_lanes=(), sl_lo=0, sl_hi=0, R_d_T0=R_D_T0,
               R_over_cv=R_OVER_CV)


@pytest.mark.parametrize("flags", [
    dict(nq=6, ngl=4), dict(na=2), dict(ngl=5)], ids=["nq6", "na2", "ngl5"])
def test_extract_kernel_refuses_unsupported_flags(flags):
    kw = dict(nq=5, na=1, ngl=4, has_hyper=True)
    kw.update(flags)
    with pytest.raises(NotImplementedError):
        surface_kernel.extract_trace_vm(
            *_meta_extract_args(kw["nq"], kw["na"], kw["ngl"]), **kw)


@pytest.mark.parametrize("flags", [
    dict(rem_lanes=(5, 6, 7), sl_lo=64, sl_hi=96, nvb=16),
    dict(nq=6, nvb=15, i_pref=7), dict(subtract=True, i_pref=5)],
    ids=["rem_lanes", "nq6", "no_subtract"])
def test_lift_kernel_refuses_unsupported_flags(flags):
    """The flux + lift takes the bundles of dg/fast_rhs.py: a remainder's
    linear lanes other than (nq+3, nq+4, nq+5), and p_ref from a lane
    other than nq + 2 (here at nq = 6, and p itself at nq = 5) are
    refused; subtract=False is covered (below)."""
    kw = dict(LIFT_KW, **flags)
    with pytest.raises(NotImplementedError):
        surface_kernel.fused_surface_lift_vm(*_meta_lift_args(kw["nvb"]),
                                             **kw)


@pytest.mark.parametrize("flags", [
    dict(nq=6, nvb=15, i_pref=8), dict(subtract=False, i_pref=5, nvb=12),
    dict(subtract=False, rem_lanes=(8, 9, 10), sl_lo=64, sl_hi=96,
         nvb=16)], ids=["nq6", "no_subtract", "remainder_no_subtract"])
def test_lift_kernel_takes_the_pallas_flags(flags):
    """nq = 6, and subtract=False (a reference state that does not
    subtract: no p_ref lane, or a remainder's bundle whose p_ref is not
    taken out) reach the kernel path, which refuses a non-CUDA tensor,
    and count no launch."""
    kw = dict(LIFT_KW, **flags)
    before = surface_kernel.fused_surface_lift_vm.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        surface_kernel.fused_surface_lift_vm(*_meta_lift_args(kw["nvb"]),
                                             **kw)
    assert surface_kernel.fused_surface_lift_vm.launches == before


@pytest.mark.parametrize("has_hyper", [True, False], ids=["hyper", "plain"])
def test_surface_wrappers_never_fall_back_off_cpu(has_hyper):
    """A tensor that is not on the CPU goes to the kernel path, which
    refuses a non-CUDA device and counts no launch."""
    before = [k.launches for k in surface_kernel.KERNELS]
    with pytest.raises(ValueError):
        surface_kernel.extract_trace_vm(*_meta_extract_args(), nq=5, na=1,
                                        ngl=4, has_hyper=has_hyper)
    with pytest.raises(ValueError):
        surface_kernel.fused_surface_lift_vm(
            *_meta_lift_args(13 if has_hyper else 8),
            **dict(LIFT_KW, has_hyper=has_hyper, nvb=13 if has_hyper else 8))
    assert [k.launches for k in surface_kernel.KERNELS] == before


@pytest.mark.parametrize("transposed", [False, True], ids=["lift", "liftT"])
def test_face_tables_built_once_per_matrix(setup, transposed):
    """The kernels' index tables of the extraction matrix: the node of each
    face lane, and the lanes of each node in ascending order, −1 padded;
    built once per matrix tensor, rebuilt after an in-place write, and
    refused for a matrix that is not 0/1."""
    lift = setup["rhs"].grid.lift.clone()
    m = lift.T.contiguous() if transposed else lift
    sel_idx, lift_idx = surface_kernel.face_tables(m, transposed)
    L = lift.numpy()
    assert np.array_equal(sel_idx.numpy(), L.argmax(0))
    for node, row in enumerate(lift_idx.numpy()):
        lanes = np.flatnonzero(L[node])
        assert np.array_equal(row[:len(lanes)], lanes)
        assert (row[len(lanes):] == -1).all()
    assert surface_kernel.face_tables(m, transposed)[0] is sel_idx
    m.mul_(2.0)
    with pytest.raises(ValueError, match="0/1"):
        surface_kernel.face_tables(m, transposed)


def test_explicit_solver_type_refuses_unported():
    cfg = held_suarez_config(2, 2, 3, dtype=torch.float64, device="cpu")
    dg = DGModel(cfg.model, cfg.grid)
    q, aux = init_ode_state(dg)
    ex = ExplicitSolverType().make(dg, q, aux, 10.0)
    assert isinstance(ex.vm, VarMajorRHS) and ex.rhs is ex.vm
    assert not ex.vm.write_aux and ex.vm.surface_kernel == "xla"
    # the grid layout is ported: the generic DG operator is the RHS
    # (tests/test_torch_grid_steps.py holds its step against JAX's)
    grid = ExplicitSolverType(state_layout="grid").make(dg, q, aux, 10.0)
    assert grid.vm is None and grid.rhs is dg

    class _Sharded(DGModel):
        inner, mesh = None, None

    with pytest.raises(NotImplementedError, match="next slice"):
        ExplicitSolverType().make(_Sharded(cfg.model, cfg.grid), q, aux,
                                  10.0)
