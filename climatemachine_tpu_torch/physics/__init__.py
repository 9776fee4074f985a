"""physics (port of climatemachine_tpu.physics)."""
