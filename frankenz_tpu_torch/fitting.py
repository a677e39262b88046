"""Fitter facade (reference `frankenz/fitting.py`).  Ported so far:
BruteForce, SelfOrganizingMap."""

from .models import BruteForce, SelfOrganizingMap  # noqa: F401

__all__ = ["BruteForce", "SelfOrganizingMap"]
