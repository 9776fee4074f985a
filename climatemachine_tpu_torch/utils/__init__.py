"""utils (port of climatemachine_tpu.utils)."""
