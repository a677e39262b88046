"""Fitters.  Ported so far: BruteForce, SelfOrganizingMap and
GrowingNeuralGas (with the shared `_Network` machinery and the learning /
neighbourhood schedules).
"""

from .bruteforce import BruteForce  # noqa: F401
from .networks import (  # noqa: F401
    GrowingNeuralGas,
    SelfOrganizingMap,
    learn_geometric,
    learn_harmonic,
    learn_linear,
    neighbor_gauss,
    neighbor_lorentz,
)
