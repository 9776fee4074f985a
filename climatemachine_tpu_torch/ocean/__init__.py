"""The ocean (port of ``climatemachine_tpu/ocean``): the hydrostatic
Boussinesq box GCM (core.py, problems.py, hydrostatic_boussinesq.py,
super_model.py), the shallow-water model (shallow_water.py), the
split-explicit coupling in its "new" variant (split_explicit.py) and the
implicit vertical diffusive convection (ivdc.py).  The split-explicit
solver's "split01" and "split01_3n" variants come in a later slice:
``SplitExplicitSolver(..., variant=...)`` and those names here raise
NotImplementedError "next slice"."""

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

#: the split-explicit variants of the JAX package that the port does not
#: have yet
NEXT_SLICE = {
    "split01": "the split-explicit variant 'split01' (multi-rate "
               "averaging, IVDC in the step)",
    "split01_3n": "the split-explicit variant 'split01_3n' (the 3N slow "
                  "recurrence)",
}


def __getattr__(name):
    if name in NEXT_SLICE:
        raise NotImplementedError(f"next slice: {NEXT_SLICE[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
