"""ode (port of climatemachine_tpu.ode)."""
