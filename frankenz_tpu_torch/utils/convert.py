"""Carry fitter state across from the JAX package.

The state of a `BruteForce` is its model set (photometry, errors, mask),
the full-mask flag and the saved fits of its last `fit` (the
(Ndata, Nmodel) grids, with the free-scale `fit_scale` / `fit_scale_err`
under ``track_scale``); the label side is a `PDFDict` (or a plain grid).
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


_SAVED_FITS = ("fit_lnprior", "fit_lnlike", "fit_lnprob", "fit_Ndim",
               "fit_chi2", "fit_scale", "fit_scale_err")


def from_jax_bruteforce(obj, device):
    """Port `BruteForce` with the model set of a `frankenz_tpu` one.

    Reads ``obj.models``, ``obj.models_err``, ``obj.models_mask`` and
    ``obj._full_mask``; dtypes are kept as the JAX object holds them.
    The saved fits (``NDATA`` and the host ``fit_*`` arrays, among them
    ``fit_scale`` / ``fit_scale_err``) are copied where present.
    """
    bf = bruteforce_from_arrays(
        np.asarray(obj.models), np.asarray(obj.models_err),
        np.asarray(obj.models_mask), full_mask=bool(obj._full_mask),
        device=device)
    bf.NDATA = getattr(obj, "NDATA", None)
    for name in _SAVED_FITS:
        value = getattr(obj, name, None)
        if value is not None:
            setattr(bf, name, np.array(value))
    return bf


def pdfdict_from(obj):
    """Rebuild a port `PDFDict` from any object with `grid`,
    `sigma_grid` and `sigma_trunc` (e.g. a `frankenz_tpu` PDFDict)."""
    from ..ops.kde import PDFDict

    return PDFDict(np.asarray(obj.grid), np.asarray(obj.sigma_grid),
                   sigma_trunc=float(obj.sigma_trunc))
