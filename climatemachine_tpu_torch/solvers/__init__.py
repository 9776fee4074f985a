"""solvers (port of climatemachine_tpu.solvers)."""
