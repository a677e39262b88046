"""Fitter facade (reference `frankenz/fitting.py`): BruteForce,
NearestNeighbors, SelfOrganizingMap, GrowingNeuralGas."""

from .models import (BruteForce, GrowingNeuralGas,  # noqa: F401
                     NearestNeighbors, SelfOrganizingMap)

__all__ = ["BruteForce", "NearestNeighbors", "SelfOrganizingMap",
           "GrowingNeuralGas"]
