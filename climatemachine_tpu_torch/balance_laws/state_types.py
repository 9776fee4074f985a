"""State categories (port of ``climatemachine_tpu/balance_laws/
state_types.py``).  Each names one array of a balance law, laid out by
its ``vars_state(category)`` schema; here every such array is var-major
``[E, nvars, L]``.
"""


class StateType:
    def __repr__(self):
        return type(self).__name__

    def __hash__(self):
        return hash(type(self))

    def __eq__(self, other):
        return type(self) is type(other)


class AbstractStateType(StateType):
    pass


class Prognostic(AbstractStateType):
    """Conserved variables q."""


class Primitive(AbstractStateType):
    """Primitive variables."""


class Auxiliary(AbstractStateType):
    """Per-node auxiliary data (coordinates, precomputed fields)."""


class Gradient(AbstractStateType):
    """Variables whose gradient the second-order flux needs."""


class GradientFlux(AbstractStateType):
    """The gradient flux σ(∇g)."""


class GradientLaplacian(AbstractStateType):
    """Variables whose Laplacian feeds hyperdiffusion."""


class Hyperdiffusive(AbstractStateType):
    """Hyperdiffusive fluxes (the gradient of the Laplacian)."""


class UpwardIntegrals(AbstractStateType):
    """Quantities integrated upward along columns."""


class DownwardIntegrals(AbstractStateType):
    """Quantities integrated downward along columns."""
