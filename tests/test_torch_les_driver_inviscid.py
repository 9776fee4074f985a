"""The port's driver entry (AtmosLESConfiguration →
make_solver_configuration → invoke) against the JAX package's on the
inviscid rising bubble (no closure), which "auto" puts on the var-major
RHS in both packages: dt, the Courant numbers, the state and norm ratio
after 10 steps of ``invoke`` within 1e-10 of the JAX package's, the
bubble rising and mass conserved (tests/les_driver_parity.py holds the
tests and their tolerances).
"""

from les_driver_parity import (  # noqa: F401
    runs_fixture, test_bubble_rises_and_conserves_mass,
    test_courant_matches_jax, test_dt_matches_jax, test_invoke_matches_jax)

runs = runs_fixture("inviscid")
