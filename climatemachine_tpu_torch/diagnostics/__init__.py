"""diagnostics (port of climatemachine_tpu.diagnostics)."""

from climatemachine_tpu_torch.diagnostics.machine import (DiagnosticsGroup,
                                                          HorizontalAverage,
                                                          PointwiseDiagnostic)
from climatemachine_tpu_torch.diagnostics.state_check import StateCheck
from climatemachine_tpu_torch.diagnostics.atmos_les import (
    AtmosLESCoreGroup, AtmosLESDefaultGroup)

__all__ = ["DiagnosticsGroup", "HorizontalAverage", "PointwiseDiagnostic",
           "StateCheck", "AtmosLESCoreGroup", "AtmosLESDefaultGroup"]
