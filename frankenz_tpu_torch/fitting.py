"""Fitter facade (reference `frankenz/fitting.py`).  Ported so far:
BruteForce, SelfOrganizingMap, GrowingNeuralGas."""

from .models import (BruteForce, GrowingNeuralGas,  # noqa: F401
                     SelfOrganizingMap)

__all__ = ["BruteForce", "SelfOrganizingMap", "GrowingNeuralGas"]
