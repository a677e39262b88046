"""
Photometry transforms: flux <-> AB magnitude and asinh magnitude
("luptitude", Lupton et al. 1999), with first-order error propagation.

Port of `frankenz_tpu.ops.transforms` (reference `frankenz/pdf.py:625-775`).
Elementwise, with the JAX module's formulas term for term.  Tensors stay
on their device; host arrays go to the card unless `device` is named
(`ops.kde._input_device`).  The dtype is kept: float64 inputs give
float64 results.
"""

from __future__ import annotations

import math

import torch

from .kde import _as, _input_device

__all__ = ["magnitude", "inv_magnitude", "luptitude", "inv_luptitude"]

_LN10 = 2.302585092994046  # log(10)
_POGSON = 2.5 / _LN10  # 2.5 * log10(e)
_LOG10_E = math.log10(math.e)


def _pair(x, xe, device):
    dev = _input_device(x, xe, device=device)
    return _as(x, dev), _as(xe, dev)


def _param(p, like):
    """A scalar parameter stays a Python number; an array one goes to the
    inputs' device (NumPy's dtype, so float64 promotes as in JAX)."""
    if isinstance(p, (int, float)):
        return p
    return torch.as_tensor(p, device=like.device)


def magnitude(phot, err, zeropoints=1.0, device=None, **kwargs):
    """Flux density -> AB magnitude, with errors (pdf.py:625-657)."""
    phot, err = _pair(phot, err, device)
    zp = _param(zeropoints, phot)
    mag = -2.5 * torch.log10(phot / zp)
    mag_err = _POGSON * err / phot
    return mag, mag_err


def inv_magnitude(mag, err, zeropoints=1.0, device=None, **kwargs):
    """AB magnitude -> flux density, with errors (pdf.py:660-692)."""
    mag, err = _pair(mag, err, device)
    zp = _param(zeropoints, mag)
    phot = 10 ** (-0.4 * mag) * zp
    phot_err = err * 0.4 * _LN10 * phot
    return phot, phot_err


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


def _sq(x):
    return torch.square(x) if isinstance(x, torch.Tensor) else x * x


def luptitude(phot, err, skynoise=1.0, zeropoints=1.0, device=None,
              **kwargs):
    """Flux density -> asinh magnitude, with errors (pdf.py:695-734).

    `skynoise` is the softening parameter b; the transform stays
    well-behaved through zero and negative fluxes, which is why the kNN
    fitter uses it as the default feature map.
    """
    phot, err = _pair(phot, err, device)
    b = _param(skynoise, phot)
    zp = _param(zeropoints, phot)
    mag = -_POGSON * (torch.asinh(phot / (2.0 * b)) + _log(b / zp))
    mag_err = torch.sqrt(torch.square(2.5 * _LOG10_E * err)
                         / (_sq(2.0 * b) + torch.square(phot)))
    return mag, mag_err


def inv_luptitude(mag, err, skynoise=1.0, zeropoints=1.0, device=None,
                  **kwargs):
    """Asinh magnitude -> flux density, with errors (pdf.py:737-775)."""
    mag, err = _pair(mag, err, device)
    b = _param(skynoise, mag)
    zp = _param(zeropoints, mag)
    phot = (2.0 * b) * torch.sinh(-mag / _POGSON - _log(b / zp))
    phot_err = torch.sqrt((_sq(2.0 * b) + torch.square(phot))
                          * torch.square(err)) / (2.5 * _LOG10_E)
    return phot, phot_err
