"""atmos (port of climatemachine_tpu.atmos)."""
