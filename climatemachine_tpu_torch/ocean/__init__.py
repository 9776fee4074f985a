"""The ocean (port of ``climatemachine_tpu/ocean``): the hydrostatic
Boussinesq box GCM (core.py, problems.py, hydrostatic_boussinesq.py,
super_model.py).  The shallow-water model, the split-explicit coupling
and the implicit vertical diffusive convection come in a later slice:
their names raise NotImplementedError "next slice"."""

from climatemachine_tpu_torch.ocean.core import (  # noqa: F401
    Coupled, FreeSlip, Impenetrable, Insulating, KinematicStress, NoSlip,
    OceanBC, Penetrable, TemperatureFlux, Uncoupled)
from climatemachine_tpu_torch.ocean.hydrostatic_boussinesq import (  # noqa
    HydrostaticBoussinesqModel, LinearHBModel, OceanForcing)

#: names of the JAX package's ocean that the port does not have yet
NEXT_SLICE = {
    "ShallowWaterModel": "the shallow-water model (ocean/shallow_water.py)",
    "ConstantViscosity": "the shallow-water model (ocean/shallow_water.py)",
    "LinearDrag": "the shallow-water model (ocean/shallow_water.py)",
    "CoupledHBModel": "the split-explicit coupling (ocean/split_explicit.py)",
    "BarotropicModel": "the split-explicit coupling (ocean/split_explicit.py)",
    "SplitExplicitSolver":
        "the split-explicit coupling (ocean/split_explicit.py)",
    "IVDCModel": "implicit vertical diffusive convection (ocean/ivdc.py)",
    "ivdc_coefficients":
        "implicit vertical diffusive convection (ocean/ivdc.py)",
    "ivdc_solve": "implicit vertical diffusive convection (ocean/ivdc.py)",
}


def __getattr__(name):
    if name in NEXT_SLICE:
        raise NotImplementedError(f"next slice: {NEXT_SLICE[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
