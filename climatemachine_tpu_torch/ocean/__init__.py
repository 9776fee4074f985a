"""The ocean (port of ``climatemachine_tpu/ocean``): the hydrostatic
Boussinesq box GCM (core.py, problems.py, hydrostatic_boussinesq.py,
super_model.py), the shallow-water model (shallow_water.py), the
split-explicit coupling in its "new", "split01" and "split01_3n"
variants (split_explicit.py) and the implicit vertical diffusive
convection (ivdc.py)."""

from climatemachine_tpu_torch.ocean.core import (  # noqa: F401
    Coupled, FreeSlip, Impenetrable, Insulating, KinematicStress, NoSlip,
    OceanBC, Penetrable, TemperatureFlux, Uncoupled)
from climatemachine_tpu_torch.ocean.hydrostatic_boussinesq import (  # noqa
    HydrostaticBoussinesqModel, LinearHBModel, OceanForcing)
from climatemachine_tpu_torch.ocean.ivdc import (  # noqa: F401
    IVDCModel, ivdc_coefficients, ivdc_solve)
from climatemachine_tpu_torch.ocean.shallow_water import (  # noqa: F401
    ConstantViscosity, LinearDrag, ShallowWaterModel)
from climatemachine_tpu_torch.ocean.split_explicit import (  # noqa: F401
    BarotropicModel, CoupledHBModel, SplitExplicitSolver)

