"""common (port of climatemachine_tpu.common)."""
