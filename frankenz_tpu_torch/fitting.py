"""Fitter facade (reference `frankenz/fitting.py`).  Ported so far:
BruteForce."""

from .models import BruteForce  # noqa: F401

__all__ = ["BruteForce"]
