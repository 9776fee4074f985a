"""mesh (port of climatemachine_tpu.mesh)."""
