"""The stable boundary layer with the bulk surface flux
(experiments/boundary_layer_les.py) in the port against the JAX package
on a 2 × 2 × 2-element box at p4 in float64, both built through the
driver entry: dt, the initial state, the aux, one RHS, and 3 steps of
``invoke`` from the JAX initial state (tests/forced_les_parity.py holds
the tests and their tolerances).
"""

from forced_les_parity import (  # noqa: F401
    runs_fixture, test_aux_matches_jax, test_dt_matches_jax,
    test_initial_state_matches_jax, test_invoke_matches_jax,
    test_rhs_matches_jax)

runs = runs_fixture("stable_bl_bulk")
