"""Fitters.  Ported so far: BruteForce."""

from .bruteforce import BruteForce  # noqa: F401
