"""Carry fitter state across from the JAX package.

The state of a `BruteForce` is its model set (photometry, errors, mask)
and the full-mask flag; the label side is a `PDFDict` (or a plain grid).
Everything here goes through NumPy: a JAX array exposes ``__array__``,
so `np.asarray` reads it without importing JAX.
"""

from __future__ import annotations

import numpy as np

__all__ = ["bruteforce_from_arrays", "from_jax_bruteforce", "pdfdict_from"]


def bruteforce_from_arrays(models, models_err, models_mask, full_mask=None,
                           device="cuda"):
    """A port `BruteForce` over host (or tensor) model arrays."""
    from ..models.bruteforce import BruteForce

    return BruteForce(models, models_err, models_mask, full_mask=full_mask,
                      device=device)


def from_jax_bruteforce(obj, device):
    """Port `BruteForce` with the model set of a `frankenz_tpu` one.

    Reads ``obj.models``, ``obj.models_err``, ``obj.models_mask`` and
    ``obj._full_mask``; dtypes are kept as the JAX object holds them.
    """
    return bruteforce_from_arrays(
        np.asarray(obj.models), np.asarray(obj.models_err),
        np.asarray(obj.models_mask), full_mask=bool(obj._full_mask),
        device=device)


def pdfdict_from(obj):
    """Rebuild a port `PDFDict` from any object with `grid`,
    `sigma_grid` and `sigma_trunc` (e.g. a `frankenz_tpu` PDFDict)."""
    from ..ops.kde import PDFDict

    return PDFDict(np.asarray(obj.grid), np.asarray(obj.sigma_grid),
                   sigma_trunc=float(obj.sigma_trunc))
