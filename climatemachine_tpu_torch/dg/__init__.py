"""dg (port of climatemachine_tpu.dg)."""
