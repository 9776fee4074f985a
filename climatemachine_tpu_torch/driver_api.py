"""One-import user API (port of ``climatemachine_tpu/driver_api.py``, with
the names the port provides): what an experiment script needs.

>>> from climatemachine_tpu_torch import driver_api as cm
>>> cm.init(show_updates="never")
>>> dc = cm.AtmosLESConfiguration("bubble", 4, (25.0,) * 3, 2500.0,
...                               2500.0, 2500.0, model)
>>> sc = cm.make_solver_configuration(0.0, 10.0, dc, Courant_number=0.4)
>>> cm.invoke(sc)

The forced LES cases: ``climatemachine_tpu_torch.experiments``
``bomex_les.bomex_config``, ``dycoms.dycoms_config``,
``boundary_layer_les.convective_bl_config`` /
``stable_bl_config`` and ``canopy_sgstke.canopy_config`` give their
``AtmosLESConfiguration``; the forcings they use are exported here.
One column: ``cm.SingleStackConfiguration(name, p, nelem_vert, zmax,
model)`` (``experiments.bomex_single_stack``; EDMF,
``cm.EDMF(...)`` as ``AtmosPhysics(turbconv=...)``, in
``experiments.bomex_edmf``).  The formulations: ``AtmosPhysics(energy=
cm.ThetaModel())`` (ρθ, dry; ``experiments.rising_bubble_theta``) and
``AtmosPhysics(compressibility=cm.Anelastic1D())``.

The GCM: ``cm.AtmosGCMConfiguration(name, p, (n_horz, n_vert), height,
model)`` for a cubed sphere, or ``cm.gcm_driver_config(...)`` for the
composable GCM experiment; a run restarts from a checkpoint with
``make_solver_configuration(..., restart_from=(directory, num))``.

The ocean box GCM: ``cm.HydrostaticBoussinesqModel(cm.OceanGyre(Lx, Ly,
H), c_h=...)`` on ``cm.ocean_box_grid(problem, nx, ny, nz, p)``, or the
one-call ``cm.HydrostaticBoussinesqSuperModel(cm.RectangularDomain(...),
time_step)``.

Diagnostics: ``cm.invoke(sc, diagnostics_config=
cm.DiagnosticsConfiguration(groups, every_steps))`` with groups of
``climatemachine_tpu_torch.diagnostics`` (``AtmosLESDefaultGroup``,
``AtmosGCMDefaultGroup`` on ``cm.InterpolationConfiguration(dc)``'s
lat-lon grid, ...), written by an ``io.writers`` writer; ``init(
debug_init=True)`` writes the initial state's VTK dump.

Time integrators: ``cm.ExplicitSolverType(solver_method=...)`` takes
LSRK54, LSRK144 or an SSPRK (``cm.SSPRK33ShuOsher``; ode/ssprk.py),
``cm.IMEXSolverType(solver_method=...)`` any ARK tableau of ode/ark.py,
``cm.MISSolverType(mis_method=, fast_method=, nsubsteps=)`` an MIS
method of ode/mis.py; driver/solver_types.py also has HEVISolverType and
ImplicitSolverType.

Grids and state live on the card unless the configuration is given
``device="cpu"`` (or ``init(disable_gpu=True)``).
"""

# flake8: noqa: F401

from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import (EARTH,
                                                         PlanetParameterSet)
from climatemachine_tpu_torch.physics.temperature_profiles import (
    DecayingTemperatureProfile, DryAdiabaticProfile, IsothermalProfile)

from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.ref_state import (HydrostaticState,
                                                      NoReferenceState)
from climatemachine_tpu_torch.atmos.sources import (
    Coriolis, GeostrophicForcing, Gravity, RayleighSponge, Subsidence)
from climatemachine_tpu_torch.atmos.boundaryconditions import (
    AtmosBC, BulkFormulaEnergy, BulkFormulaMoisture, DragLaw, FreeSlip,
    Impenetrable, Impermeable, InitStateBC, Insulating, NoSlip,
    PrescribedEnergyFlux, PrescribedMoistureFlux, PrescribedTemperature)
from climatemachine_tpu_torch.atmos.compressibility import (Anelastic1D,
                                                            Compressible)
from climatemachine_tpu_torch.atmos.edmf import EDMF
from climatemachine_tpu_torch.atmos.energy import (ThetaModel,
                                                   TotalEnergyModel)
from climatemachine_tpu_torch.atmos.hyperdiffusion import (
    DryBiharmonic, EquilMoistBiharmonic)
from climatemachine_tpu_torch.atmos.lsforcing import HadGEMVertical
from climatemachine_tpu_torch.atmos.moisture import (DryModel, EquilMoist,
                                                     NonEquilMoist)
from climatemachine_tpu_torch.atmos.precipitation import (RainModel,
                                                          RainSnowModel)
from climatemachine_tpu_torch.atmos.radiation import (DYCOMSRadiationModel,
                                                      NoRadiation)
from climatemachine_tpu_torch.atmos.tracers import NTracers

from climatemachine_tpu_torch.common.orientations import (
    FlatOrientation, NoOrientation, SphericalOrientation)
from climatemachine_tpu_torch.common.turbulence import (
    AnisoMinDiss, ConstantDynamicViscosity, ConstantKinematicViscosity,
    Deardorff, SmagorinskyLilly, UpperAtmosSponge, Vreman)

from climatemachine_tpu_torch.dg.spatial import (DGModel, init_ode_state,
                                                 remainder_DGModel)
from climatemachine_tpu_torch.dg.numerical_fluxes import (
    CentralNumericalFluxFirstOrder, CentralNumericalFluxGradient,
    CentralNumericalFluxSecondOrder,
    HLLCNumericalFlux, LMARSNumericalFlux, RoeNumericalFlux,
    RusanovNumericalFlux)
from climatemachine_tpu_torch.dg.courant import calculate_dt

from climatemachine_tpu_torch.mesh.grid import make_grid, min_node_distance
from climatemachine_tpu_torch.mesh import topology

from climatemachine_tpu_torch.ode.lsrk import (LSRK54CarpenterKennedy,
                                               LSRK144NiegemannDiehlBusch)
from climatemachine_tpu_torch.ode.ssprk import SSPRK33ShuOsher
from climatemachine_tpu_torch.ode.solve import solve

from climatemachine_tpu_torch.driver.callbacks import (
    AdaptTimestep, CheckpointCallback, ConservationCheck, MonitorCourant,
    MonitorTimestepDuration, show_not_finite_fields)
from climatemachine_tpu_torch.driver.checkpoint import (read_checkpoint,
                                                        write_checkpoint)
from climatemachine_tpu_torch.driver.diagnostics_configs import (
    DiagnosticsConfiguration, InterpolationConfiguration)
from climatemachine_tpu_torch.driver.configs import (
    AtmosGCMConfiguration, AtmosLESConfiguration, DriverConfiguration,
    SingleStackConfiguration)
from climatemachine_tpu_torch.driver.driver import SETTINGS, init, invoke
from climatemachine_tpu_torch.driver.solver_configs import (
    SolverConfiguration, make_solver_configuration)
from climatemachine_tpu_torch.driver.solver_types import (
    ExplicitSolverType, IMEXSolverType, MISSolverType, MultirateSolverType,
    SplitExplicitSolverType)

from climatemachine_tpu_torch.experiments.gcm_driver import (
    VaryingSSTTJ16, gcm_driver_config)

from climatemachine_tpu_torch.ocean.hydrostatic_boussinesq import (
    HydrostaticBoussinesqModel)
from climatemachine_tpu_torch.ocean.problems import (OceanGyre, SimpleBox,
                                                     ocean_box_grid)
from climatemachine_tpu_torch.ocean.shallow_water import ShallowWaterModel
from climatemachine_tpu_torch.ocean.split_explicit import (
    BarotropicModel, CoupledHBModel, SplitExplicitSolver)
from climatemachine_tpu_torch.ocean.super_model import (
    HydrostaticBoussinesqSuperModel, InitialConditions, RectangularDomain)

from climatemachine_tpu_torch.diagnostics.machine import (DiagnosticsGroup,
                                                          HorizontalAverage,
                                                          PointwiseDiagnostic,
                                                          atmos_default_vars,
                                                          atmos_les_profiles)
