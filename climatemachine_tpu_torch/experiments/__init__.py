"""experiments (port of climatemachine_tpu.experiments)."""
