"""Rules of the PyTorch port that hold without a card: it imports no JAX,
entry points refuse to fall back to the CPU, and the kernel wrappers
refuse what their kernels do not cover instead of quietly running the
plain version."""

import ast
import pathlib
from dataclasses import replace

import pytest
import torch

from climatemachine_tpu.dg.spatial import \
    direction_dims as jax_direction_dims
from climatemachine_tpu.dg.spatial import \
    direction_faces as jax_direction_faces
from climatemachine_tpu_torch import cuda_build, resolve_device
from climatemachine_tpu_torch.atmos.hyperdiffusion import DryBiharmonic
from climatemachine_tpu_torch.atmos.linear import \
    AtmosAcousticGravityLinearModel
from climatemachine_tpu_torch.atmos.model import AtmosModel
from climatemachine_tpu_torch.dg import (dry_volume_kernel, ldg_kernel,
                                        ldg_tables, surface_kernel,
                                        volume_kernel)
from climatemachine_tpu_torch.dg.fast_rhs import VarMajorRHS
from climatemachine_tpu_torch.dg.spatial import (DGModel, direction_dims,
                                                 direction_faces,
                                                 init_ode_state)
from climatemachine_tpu_torch.driver.solver_types import (ExplicitSolverType,
                                                          IMEXSolverType)
from climatemachine_tpu_torch.experiments.held_suarez import \
    held_suarez_config
from climatemachine_tpu_torch.physics.parameters import EARTH
from climatemachine_tpu_torch.solvers import layout_kernel

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "climatemachine_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "climatemachine_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


#: the LES slice's modules, which test_port_imports_no_jax must scan
LES_MODULES = ("common/turbulence.py", "dg/courant.py", "ode/solve.py",
               "driver/callbacks.py", "driver/configs.py",
               "driver/driver.py", "driver/solver_configs.py",
               "driver_api.py", "atmos/boundaryconditions.py",
               "physics/temperature_profiles.py", "mesh/topology.py",
               "experiments/risingbubble.py")


def test_scan_reaches_les_modules():
    assert {ROOT / "climatemachine_tpu_torch" / m
            for m in LES_MODULES} <= set(PORT_FILES)


#: the ocean slice's modules, which test_port_imports_no_jax must scan
OCEAN_MODULES = ("balance_laws/__init__.py", "balance_laws/interface.py",
                 "balance_laws/state_types.py", "dg/columns.py",
                 "mesh/filters.py", "ode/lsrk3n.py", "ocean/__init__.py",
                 "ocean/core.py", "ocean/problems.py",
                 "ocean/hydrostatic_boussinesq.py", "ocean/super_model.py",
                 "common/cartesian_fields.py", "experiments/ocean_box.py")


def test_scan_reaches_ocean_modules():
    assert {ROOT / "climatemachine_tpu_torch" / m
            for m in OCEAN_MODULES} <= set(PORT_FILES)


#: the split-explicit slice's modules, which test_port_imports_no_jax
#: must scan
SPLIT_EXPLICIT_MODULES = ("ocean/shallow_water.py", "ocean/split_explicit.py",
                          "ocean/ivdc.py", "solvers/iterative.py",
                          "experiments/ocean_split_explicit.py",
                          "mesh/metrics.py", "mesh/grid.py")


def test_scan_reaches_split_explicit_modules():
    assert {ROOT / "climatemachine_tpu_torch" / m
            for m in SPLIT_EXPLICIT_MODULES} <= set(PORT_FILES)


#: the forced LES slice's modules, which test_port_imports_no_jax must
#: scan
FORCED_LES_MODULES = ("atmos/radiation.py", "atmos/sgstke.py",
                      "atmos/canopy.py", "atmos/lsforcing.py",
                      "atmos/sources.py", "atmos/moisture.py",
                      "atmos/model.py", "common/surface_fluxes.py",
                      "common/orientations.py", "mesh/filters.py",
                      "physics/thermodynamics.py",
                      "experiments/bomex_les.py", "experiments/dycoms.py",
                      "experiments/boundary_layer_les.py",
                      "experiments/canopy_sgstke.py",
                      "experiments/forced_les.py")


def test_scan_reaches_forced_les_modules():
    assert {ROOT / "climatemachine_tpu_torch" / m
            for m in FORCED_LES_MODULES} <= set(PORT_FILES)


#: the diagnostics and output slice's modules, which
#: test_port_imports_no_jax must scan (common/spectra.py and io/vtk.py
#: import no JAX in the JAX package either: the port keeps its own copy)
DIAGNOSTICS_MODULES = ("common/spectra.py", "mesh/interpolation.py",
                       "io/__init__.py", "io/writers.py", "io/vtk.py",
                       "diagnostics/__init__.py", "diagnostics/machine.py",
                       "diagnostics/atmos_les.py", "diagnostics/fields.py",
                       "diagnostics/groups_extra.py",
                       "diagnostics/state_check.py",
                       "driver/diagnostics_configs.py",
                       "balance_laws/show_tendencies.py",
                       "utils/tictoc.py", "utils/single_stack.py")


def test_scan_reaches_diagnostics_modules():
    assert {ROOT / "climatemachine_tpu_torch" / m
            for m in DIAGNOSTICS_MODULES} <= set(PORT_FILES)


@pytest.mark.parametrize("name", ["ShallowWaterModel", "ConstantViscosity",
                                  "CoupledHBModel", "BarotropicModel",
                                  "SplitExplicitSolver", "IVDCModel",
                                  "ivdc_coefficients", "ivdc_solve"])
def test_next_slice_ocean_names_raise(name):
    """The shallow-water model, the split-explicit coupling and IVDC are
    ported: each name is its module's object.  The split01 variants are
    ported too: their names are not attributes of the package (no "next
    slice" stand-in is left), nor is any other missing name."""
    import climatemachine_tpu_torch.ocean as ocean
    from climatemachine_tpu_torch.ocean import (ivdc, shallow_water,
                                                split_explicit)
    assert any(getattr(ocean, name) is getattr(m, name, None)
               for m in (ivdc, shallow_water, split_explicit))
    assert not hasattr(ocean, "NEXT_SLICE")
    for missing in ("split01", "split01_3n", "NoSuchModel"):
        with pytest.raises(AttributeError):
            getattr(ocean, missing)


def test_coupled_ocean_refused():
    """The coupling is stored, as in the JAX package (CoupledHBModel
    brings the coupled physics); the split-explicit solver refuses a
    variant the JAX package does not have, and no longer the split01
    ones."""
    from climatemachine_tpu_torch.ocean import (Coupled,
                                                HydrostaticBoussinesqModel)
    from climatemachine_tpu_torch.ocean.problems import OceanGyre
    from climatemachine_tpu_torch.ocean.split_explicit import (
        CoupledHBModel, SplitExplicitSolver)
    problem = OceanGyre(1e6, 1e6, 400.0)
    m = HydrostaticBoussinesqModel(problem, coupling=Coupled())
    assert isinstance(m.coupling, Coupled)
    assert isinstance(CoupledHBModel(problem).coupling, Coupled)
    assert CoupledHBModel(problem, add_fast_substeps=2).add_fast_substeps \
        == 2
    with pytest.raises(ValueError):
        SplitExplicitSolver(None, None, None, None, variant="split02")


@pytest.mark.parametrize("name", ["sgstke", "lsforcing", "turbconv",
                                  "radiation"])
def test_unported_physics_refused(name):
    """Every one of these AtmosPhysics fields is ported now: the SGS TKE
    model, the large-scale forcing and EDMF (``turbconv``) build with a
    turbulence closure (the gradient pass) and raise ValueError without
    one; radiation builds.  EDMF's ``turbconv.`` lanes are in the state,
    aux, gradient and gradient-flux specs."""
    from climatemachine_tpu_torch.atmos.edmf import EDMF
    from climatemachine_tpu_torch.atmos.lsforcing import HadGEMVertical
    from climatemachine_tpu_torch.atmos.model import (AtmosPhysics,
                                                      AtmosProblem)
    from climatemachine_tpu_torch.atmos.radiation import \
        DYCOMSRadiationModel
    from climatemachine_tpu_torch.atmos.sgstke import SGStkeModel
    from climatemachine_tpu_torch.common.turbulence import Deardorff
    part = {"sgstke": SGStkeModel(), "radiation": DYCOMSRadiationModel(),
            "lsforcing": HadGEMVertical(lambda z: {}),
            "turbconv": EDMF()}[name]
    model = AtmosModel(AtmosPhysics(turbulence=Deardorff(),
                                    **{name: part}), AtmosProblem())
    assert f"{name}." in " ".join(model.prog_spec.flattened_names()
                                  + model.aux_spec.flattened_names())
    if name == "turbconv":
        for spec in (model.prog_spec, model.aux_spec, model.grad_spec,
                     model.gf_spec):
            assert any(n.startswith("turbconv.")
                       for n in spec.flattened_names())
        assert "turbconv.up_rhoa" in model.prog_spec.flattened_names()
    if name != "radiation":
        with pytest.raises(ValueError, match="turbulence closure"):
            AtmosModel(AtmosPhysics(**{name: part}), AtmosProblem())


@pytest.mark.parametrize("formulation", ["theta", "anelastic", "turbconv"])
def test_var_major_rhs_refuses_formulations(formulation):
    """VarMajorRHS refuses ThetaModel, Anelastic1D and EDMF with a
    message naming the generic DG operator (the JAX package's
    ``fast_rhs.supports`` refuses them too), and neither the dry volume
    kernel nor the fast surface pass takes them."""
    from climatemachine_tpu_torch.atmos.compressibility import Anelastic1D
    from climatemachine_tpu_torch.atmos.edmf import EDMF
    from climatemachine_tpu_torch.atmos.energy import ThetaModel
    from climatemachine_tpu_torch.atmos.model import (AtmosPhysics,
                                                      AtmosProblem)
    from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
    from climatemachine_tpu_torch.common.turbulence import \
        ConstantKinematicViscosity
    from climatemachine_tpu_torch.dg import (dry_volume_kernel, fast_rhs,
                                             fast_surface)
    from climatemachine_tpu_torch.dg.spatial import DGModel
    from climatemachine_tpu_torch.mesh.grid import make_grid
    from climatemachine_tpu_torch.mesh.topology import single_stack_topology
    from climatemachine_tpu_torch.physics.temperature_profiles import \
        DryAdiabaticProfile
    ref = HydrostaticState(DryAdiabaticProfile(300.0, 110.0))
    physics = {
        "theta": AtmosPhysics(ref_state=ref, energy=ThetaModel()),
        "anelastic": AtmosPhysics(ref_state=ref,
                                  compressibility=Anelastic1D()),
        "turbconv": AtmosPhysics(
            ref_state=ref, turbulence=ConstantKinematicViscosity(0.0),
            turbconv=EDMF())}[formulation]
    grid = make_grid(single_stack_topology(10.0, 10.0, [0.0, 10.0, 20.0]),
                     2, dtype=torch.float64, device="cpu")
    dg = DGModel(AtmosModel(physics, AtmosProblem()), grid)
    with pytest.raises(ValueError, match="generic DG operator"):
        fast_rhs.VarMajorRHS(dg)
    assert not fast_rhs.supports(dg)
    assert not fast_surface.supports(dg)
    assert not dry_volume_kernel.supports(dg.balance_law, grid, "every")
    assert not dg.dry_volume and not dg.fast_surface


#: the numerics slice's modules, which test_port_imports_no_jax must scan
NUMERICS_MODULES = ("ode/ark.py", "ode/ssprk.py", "ode/mis.py",
                    "ode/mrigark.py", "ode/external.py", "mesh/dss.py",
                    "solvers/iterative.py", "driver/solver_types.py",
                    "driver_api.py", "experiments/rising_bubble_bryan.py",
                    "experiments/timestepping_compare.py")


def test_scan_reaches_numerics_modules():
    assert {ROOT / "climatemachine_tpu_torch" / m
            for m in NUMERICS_MODULES} <= set(PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        held_suarez_config(2, 2, 3, hyperdiffusion_tau=None)
    assert resolve_device("cpu") == torch.device("cpu")


def _meta_args(nq=5, E=8, Np=64):
    t = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")
    return (t(E, nq, Np), t(E, Np), t(E, Np), t(E, Np), t(E, 3, Np),
            t(E, 12, Np), t(E, 2, Np), t(E, 9, Np), t(E, Np), t(E, Np),
            t(Np, 3 * Np))


def _dry_meta_args(E=8, Np=64):
    t = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")
    return (t(E, 5, Np), t(E, Np), t(E, Np), t(E, 3, Np), t(E, 9, Np),
            t(E, Np), t(E, Np), t(Np, 3 * Np))


#: (kernel wrapper, flags it does not cover), none of them a branch of the
#: Pallas kernels: the hyperdiffusive flux F₂ of nq variables has nq − 1
#: chain variables (ngl ≠ nq − 1 is not a model's), and a remainder's
#: lin_dims are those of "vertical", "horizontal" or "every" (no direction
#: yields (1, 2), (0,) or (1,)); the kernels are built for the widths of
#: the port's models, nq = 5 and 6
UNSUPPORTED = {
    "nq6": ("volume", dict(nq=6, has_f2=True, ngl=4)),
    "has_f2": ("volume", dict(has_f2=True, ngl=5)),
    "nq7": ("volume", dict(nq=7)),
    "lin_slots": ("volume", dict(lin_dims=(1, 2))),
    "lin_x": ("volume", dict(lin_dims=(0,), subtract_ref=False)),
    "dry_lin_slots": ("dry", dict(lin_dims=(1, 2))),
    "dry_lin_y": ("dry", dict(lin_dims=(1,), subtract_ref=False)),
}

#: the branches each wrapper takes to its kernel: the remainders, and with
#: subtract_ref=False (a NoReferenceState, or a HydrostaticState that does
#: not subtract) with and without them; the var-major kernel's "horizontal"
#: lin_dims (0, 1) too
REMAINDER_BRANCHES = {
    "lin_dims": ("volume", dict(lin_dims=(0, 1))),
    "no_subtract": ("volume", dict(subtract_ref=False)),
    "lin_every_no_subtract": ("volume", dict(lin_dims=(0, 1, 2),
                                             subtract_ref=False)),
    "lin_acoustic_no_subtract": ("volume", dict(
        lin_dims=(2,), lin_gravity=False, subtract_ref=False)),
    "dry_lin_every": ("dry", dict(lin_dims=(0, 1, 2), subtract_ref=False)),
    "dry_lin_acoustic": ("dry", dict(lin_dims=(2,), lin_gravity=False,
                                     subtract_ref=False)),
    "dry_lin_horizontal": ("dry", dict(lin_dims=(0, 1), subtract_ref=False)),
    "dry_no_subtract": ("dry", dict(subtract_ref=False)),
    "vertical": ("volume", dict(lin_dims=(2,))),
    "vertical_acoustic": ("volume", dict(lin_dims=(2,), lin_gravity=False)),
    "every": ("volume", dict(lin_dims=(0, 1, 2))),
    "every_acoustic": ("volume", dict(lin_dims=(0, 1, 2),
                                      lin_gravity=False)),
    "moist_every_f2": ("volume", dict(nq=6, ngl=5, has_f2=True,
                                      lin_dims=(0, 1, 2))),
    "dry_vertical_acoustic": ("dry", dict(lin_dims=(2,),
                                          lin_gravity=False)),
    "dry_horizontal": ("dry", dict(lin_dims=(0, 1))),
    "dry_every": ("dry", dict(lin_dims=(0, 1, 2))),
    "dry_every_acoustic": ("dry", dict(lin_dims=(0, 1, 2),
                                       lin_gravity=False)),
}


@pytest.mark.parametrize("flags", list(UNSUPPORTED.values()),
                         ids=list(UNSUPPORTED))
def test_kernel_wrapper_refuses_unsupported_flags(flags):
    wrapper, flags = flags
    kw = dict(R_d=EARTH.R_d, cv_d=EARTH.cv_d, T_0=EARTH.T_0)
    if wrapper == "dry":
        with pytest.raises(NotImplementedError):
            dry_volume_kernel.dry_volume_tendency(*_dry_meta_args(),
                                                  **kw, **flags)
        return
    kw.update(nq=5, ngl=4)
    kw.update(flags)
    with pytest.raises(NotImplementedError):
        volume_kernel.fused_volume_tendency_vm(*_meta_args(kw["nq"]), **kw)


@pytest.mark.parametrize("flags", list(REMAINDER_BRANCHES.values()),
                         ids=list(REMAINDER_BRANCHES))
def test_remainder_branches_reach_the_kernel(flags):
    """Each remainder branch the kernels are built for passes the
    wrapper's refusal and reaches the kernel path, which refuses a
    non-CUDA tensor (here on the meta device) and counts no launch."""
    wrapper, flags = flags
    kw = dict(R_d=EARTH.R_d, cv_d=EARTH.cv_d, T_0=EARTH.T_0, **flags)
    if wrapper == "dry":
        fn, args = dry_volume_kernel.dry_volume_tendency, _dry_meta_args()
    else:
        kw.setdefault("nq", 5)
        kw.setdefault("ngl", 4)
        fn = volume_kernel.fused_volume_tendency_vm
        args = _meta_args(kw["nq"])
        if kw.get("has_f2"):
            t = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")
            args = args[:5] + (t(8, 3 * kw["ngl"], 64),) + args[6:]
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*args, **kw)
    assert fn.launches == before


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


#: the surface kernels' remainder calls (nq, hyperdiffusion, linear face
#: lanes of 96): the remainder without the reference pressure taken out
#: reaches the kernel; linear lanes other than those of dg/fast_rhs.py's
#: bundle (nq+3, nq+4, nq+5) and a face range past the faces are refused
SURFACE_REMAINDER = {
    "vertical_hyper": (dict(nq=5, has_hyper=True), (64, 96), None),
    "every_moist": (dict(nq=6, has_hyper=False), (0, 96), None),
    "no_subtract": (dict(nq=5, has_hyper=True, subtract=False), (0, 96),
                    None),
    "other_lanes": (dict(nq=5, has_hyper=True, rem_lanes=(5, 6, 7)),
                    (0, 96), NotImplementedError),
    "lanes_past_faces": (dict(nq=5, has_hyper=False), (64, 128),
                         ValueError),
}
REFUSAL = {"other_lanes": "covers", "lanes_past_faces": "not within"}


@pytest.mark.parametrize("case", list(SURFACE_REMAINDER))
def test_surface_remainder_wrappers(case):
    """The extraction at na = 4 and the flux + lift with ``rem_lanes``
    reach the kernel path, which refuses a non-CUDA tensor, with and
    without ``subtract``; other linear lanes and a face range past the
    faces are refused first.  No launch is counted."""
    flags, (lo, hi), refused = SURFACE_REMAINDER[case]
    nq, hyper = flags["nq"], flags["has_hyper"]
    E, Np, X = 8, 64, 96
    nvb = nq + 6 + nq * hyper
    before = [k.launches for k in surface_kernel.KERNELS]
    kw = dict(nvb=nvb, subtract=True, i_pref=nq + 2,
              rem_lanes=(nq + 3, nq + 4, nq + 5), sl_lo=lo, sl_hi=hi,
              R_d_T0=EARTH.R_d * EARTH.T_0, R_over_cv=EARTH.R_d / EARTH.cv_d)
    kw.update(flags)
    match = REFUSAL.get(case, "CUDA tensors")
    with pytest.raises(refused or ValueError, match=match):
        surface_kernel.fused_surface_lift_vm(
            _meta(E, nvb, X), _meta(E, nvb, X), _meta(E, 3, X),
            _meta(E, 1, X), _meta(E, 1, X), _meta(X, Np), _meta(E, Np), **kw)
    if refused is None:
        with pytest.raises(ValueError, match="CUDA tensors"):
            surface_kernel.extract_trace_vm(
                _meta(E, nq, Np), _meta(E, Np), _meta(E, Np),
                _meta(E, 4, Np), _meta(E, 3 * (nq - 1), Np),
                _meta(E, 2, Np), _meta(Np, X), _meta(E, 3, X), nq=nq, na=4,
                ngl=nq - 1, has_hyper=hyper)
    assert [k.launches for k in surface_kernel.KERNELS] == before


#: the surface kernels' calls without a remainder: the vortex's bundle
#: (na = 0, subtract=False: no p_ref lane), the Held-Suarez one (na = 1),
#: and what stays refused: an aux width no bundle has, ngl ≠ nq − 1, p_ref
#: from another lane than nq + 2
SURFACE_BUNDLES = {
    "na0": (dict(nq=5, na=0, has_hyper=False), None),
    "na0_hyper_moist": (dict(nq=6, na=0, has_hyper=True), None),
    "na1": (dict(nq=5, na=1, has_hyper=False), None),
    "na2": (dict(nq=5, na=2, has_hyper=False), NotImplementedError),
    "ngl": (dict(nq=6, na=0, has_hyper=True, ngl=4), NotImplementedError),
    "pref_other_lane": (dict(nq=5, na=1, has_hyper=False, subtract=True,
                             i_pref=5), NotImplementedError),
}


@pytest.mark.parametrize("case", list(SURFACE_BUNDLES))
def test_surface_bundle_wrappers(case):
    """The extraction at na = 0, 1 and the flux + lift without a remainder,
    with ``subtract`` where the bundle has p_ref (na > 0) and without it
    where it has none, reach the kernel path, which refuses a non-CUDA
    tensor; the refused calls raise first.  No launch is counted."""
    flags, refused = SURFACE_BUNDLES[case]
    nq, na, hyper = flags["nq"], flags["na"], flags["has_hyper"]
    ngl = flags.get("ngl", nq - 1)
    E, Np, X = 8, 64, 96
    nvb = nq + 2 + na + nq * hyper
    before = [k.launches for k in surface_kernel.KERNELS]
    match = {None: "CUDA tensors", NotImplementedError: "covers"}[refused]
    lift_kw = dict(nq=nq, nvb=nvb, subtract=flags.get("subtract", na > 0),
                   i_pref=flags.get("i_pref", nq + 2 if na else nq),
                   has_hyper=hyper,
                   rem_lanes=(), sl_lo=0, sl_hi=0,
                   R_d_T0=EARTH.R_d * EARTH.T_0,
                   R_over_cv=EARTH.R_d / EARTH.cv_d)
    if case != "ngl":
        with pytest.raises(refused or ValueError, match=match):
            surface_kernel.fused_surface_lift_vm(
                _meta(E, nvb, X), _meta(E, nvb, X), _meta(E, 3, X),
                _meta(E, 1, X), _meta(E, 1, X), _meta(X, Np), _meta(E, Np),
                **lift_kw)
    if case != "pref_other_lane":
        with pytest.raises(refused or ValueError, match=match):
            surface_kernel.extract_trace_vm(
                _meta(E, nq, Np), _meta(E, Np), _meta(E, Np),
                _meta(E, na, Np), _meta(E, 3 * ngl, Np), _meta(E, 2, Np),
                _meta(Np, X), _meta(E, 3, X), nq=nq, na=na, ngl=ngl,
                has_hyper=hyper)
    assert [k.launches for k in surface_kernel.KERNELS] == before


def test_kernel_wrapper_never_falls_back_off_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which
    refuses a non-CUDA device instead of running the plain version."""
    kw = dict(nq=5, ngl=1, R_d=EARTH.R_d, cv_d=EARTH.cv_d, T_0=EARTH.T_0)
    before = volume_kernel.fused_volume_tendency_vm.launches
    with pytest.raises(ValueError):
        volume_kernel.fused_volume_tendency_vm(*_meta_args(), **kw)
    assert volume_kernel.fused_volume_tendency_vm.launches == before


@pytest.mark.parametrize("lin_dims", [(), (2,)],
                         ids=["no_remainder", "remainder"])
def test_dry_kernel_wrapper_never_falls_back_off_cpu(lin_dims):
    """The dry volume kernel's wrapper: a tensor that is not on the CPU
    goes to the kernel path, which refuses a non-CUDA device and counts
    no launch."""
    wrapper = dry_volume_kernel.dry_volume_tendency
    before = wrapper.launches
    with pytest.raises(ValueError):
        wrapper(*_dry_meta_args(), R_d=EARTH.R_d, cv_d=EARTH.cv_d,
                T_0=EARTH.T_0, lin_dims=lin_dims)
    assert wrapper.launches == before


def _chain_meta_args(stage, E=8, n=4, nd=2, Np=64, F=64):
    t = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")
    i = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")
    fo = ldg_tables.FaceOps(Sel=t(Np, F), LT=t(F, Np), sel_idx=i(F),
                            lift_idx=i(Np, 2))
    xi, Wd, MI = t(E, nd * 3, Np), t(nd, Np, Np), t(E, Np)
    return {"ldg_first": (t(E, n, Np), xi, Wd, fo),
            "ldg_grad_to_div": (t(E, 3, n, Np), t(E, n, F), t(E, 3, F),
                                t(E, 3, F), MI, xi, Wd, fo),
            "ldg_div_to_grad": (t(E, n, Np), t(E, n, F), t(E, F), MI, xi,
                                Wd, fo),
            "ldg_last": (t(E, 3, n, Np), t(E, n, F), t(E, 3, F), MI,
                         fo)}[stage]


@pytest.mark.parametrize("stage", ["ldg_first", "ldg_grad_to_div",
                                   "ldg_div_to_grad", "ldg_last"])
def test_chain_wrapper_never_falls_back_off_cpu(stage):
    """A chain tensor that is not on the CPU goes to the kernel path,
    which refuses a non-CUDA device and counts no launch."""
    wrapper = getattr(ldg_kernel, stage)
    before = wrapper.launches
    with pytest.raises(ValueError):
        wrapper(*_chain_meta_args(stage))
    assert wrapper.launches == before


@pytest.mark.parametrize("stage", ["ldg_first", "ldg_grad_to_div",
                                   "ldg_div_to_grad", "ldg_last"])
def test_chain_wrapper_refuses_rows_other_than_four(stage):
    """Every chain kernel is built for n = 4 rows (dry) and n = 5 (moist):
    the wrapper refuses another n before it looks at the device, and
    counts no launch."""
    wrapper = getattr(ldg_kernel, stage)
    before = wrapper.launches
    with pytest.raises(NotImplementedError, match="n=4 or n=5 rows"):
        wrapper(*_chain_meta_args(stage, n=6))
    assert wrapper.launches == before


@pytest.mark.parametrize("stage", ["ldg_first", "ldg_grad_to_div",
                                   "ldg_div_to_grad"])
@pytest.mark.parametrize("nd", [1, 3])
def test_chain_wrapper_refuses_other_direction_counts(stage, nd):
    """K1-K3 are built for the nd = 2 derivative directions of the
    horizontal hyperdiffusion: the wrapper refuses another nd before it
    looks at the device, and counts no launch."""
    wrapper = getattr(ldg_kernel, stage)
    before = wrapper.launches
    with pytest.raises(NotImplementedError, match="nd=2 directions"):
        wrapper(*_chain_meta_args(stage, nd=nd))
    assert wrapper.launches == before


@pytest.mark.parametrize("name", ["to_blocks_vm", "from_blocks_vm"])
def test_layout_wrapper_never_falls_back_off_cpu(name):
    """A layout tensor that is not on the CPU goes to the kernel path,
    which refuses a non-CUDA device and counts no launch."""
    wrapper = getattr(layout_kernel, name)
    dims = (4, 2, 5, 3, 9)
    shape = (8, 5, 27) if name == "to_blocks_vm" else (2, 15, 36)
    before = wrapper.launches
    with pytest.raises(ValueError):
        wrapper(torch.empty(shape, dtype=torch.float32, device="meta"), dims)
    assert wrapper.launches == before


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", ["to_blocks_vm", "from_blocks_vm"])
def test_layout_runtime_dims_entry_is_kernel_only(name, device):
    """The runtime-dims entries (chip_smoke.py holds that branch at the
    constant shapes) launch the kernel or raise: no plain version on any
    device, no launch counted."""
    wrapper = getattr(layout_kernel, name)
    entry = getattr(layout_kernel, name + "_runtime_dims")
    dims = (1536, 8, 9, 5, 25)
    shape = (12288, 9, 125) if name == "to_blocks_vm" else (8, 45, 38400)
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        entry(torch.empty(shape, dtype=torch.float32, device=device), dims)
    assert wrapper.launches == before


@pytest.mark.parametrize("source", ["volume_vm", "ldg_chain",
                                    "column_layout", "surface_vm"])
def test_build_without_nvcc_raises(monkeypatch, tmp_path, source):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build(source)


class _OtherBiharmonic(DryBiharmonic):
    """A hyperdiffusion that is not DryBiharmonic itself (the moist one
    waits for moisture)."""


def test_next_slice_configurations_raise():
    """What is not ported raises "next slice": a hyperdiffusion other
    than DryBiharmonic (in the var-major RHS and the generic DG
    operator), a sharded model and a reduced-precision column operator
    (banded and dense); the var-major RHS refuses a remainder in
    "horizontal", as the JAX package's does.  The generic DG operator on
    the full AtmosModel and with a remainder, the var-major RHS on a
    remainder in "vertical" and "every", the grid layout, the dense
    solver and the ARK step without a block layout are ported
    (tests/test_torch_generic_dg.py, test_torch_remainder_rhs.py,
    test_torch_grid_steps.py, test_torch_dense_imex.py)."""
    cfg = held_suarez_config(2, 2, 3, dtype=torch.float64, device="cpu")
    assert type(cfg.model.physics.hyperdiffusion) is DryBiharmonic
    VarMajorRHS(DGModel(cfg.model, cfg.grid))      # the default now builds
    lin = AtmosAcousticGravityLinearModel(cfg.model)
    for ldir in ("vertical", "every"):
        VarMajorRHS(DGModel(cfg.model, cfg.grid, remainder=(lin, ldir)))
    with pytest.raises(ValueError, match="'vertical' or 'every'"):
        VarMajorRHS(DGModel(cfg.model, cfg.grid,
                            remainder=(lin, "horizontal")))
    m = cfg.model
    hyper = AtmosModel(replace(m.physics,
                               hyperdiffusion=_OtherBiharmonic(3600.0)),
                       m.problem, m.sources)
    with pytest.raises(NotImplementedError, match="next slice"):
        DGModel(hyper, cfg.grid)
    dg_hyper = DGModel(m, cfg.grid)
    dg_hyper.balance_law = hyper
    with pytest.raises(NotImplementedError, match="next slice"):
        VarMajorRHS(dg_hyper)

    dg = DGModel(cfg.model, cfg.grid)
    q, aux = init_ode_state(dg)
    dt = 10.0

    class _Sharded(DGModel):
        inner, mesh = None, None

    for kw in (dict(), dict(state_layout="grid"),
               dict(columnwise_solver="dense")):
        with pytest.raises(NotImplementedError, match="next slice"):
            IMEXSolverType(**kw).make(_Sharded(m, cfg.grid), q, aux, dt)
    with pytest.raises(NotImplementedError, match="next slice"):
        ExplicitSolverType(state_layout="grid").make(_Sharded(m, cfg.grid),
                                                     q, aux, dt)
    for kw in (dict(), dict(columnwise_solver="dense")):
        imex = IMEXSolverType(**kw).make(dg, q, aux, dt)
        with pytest.raises(NotImplementedError, match="next slice"):
            imex.solver.op_args(torch.bfloat16)


@pytest.mark.parametrize("direction", ["every", "horizontal", "vertical"])
def test_directions_match_jax(direction):
    """Reference dims and faces of each direction, as the JAX package
    gives them."""
    assert direction_dims(direction, 3) == jax_direction_dims(direction, 3)
    assert direction_faces(direction, 3) == \
        jax_direction_faces(direction, 3)
    with pytest.raises(ValueError):
        direction_dims("diagonal", 3)
