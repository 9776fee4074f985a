"""driver (port of climatemachine_tpu.driver)."""
