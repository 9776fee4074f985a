"""io (port of climatemachine_tpu.io): dataset writers and VTK output."""
