"""
IGM attenuation: Madau (1995/1999) effective transmission.

Port of `frankenz_tpu.sim.igm` (reference `frankenz/reddening.py:23-95`):
Lyman-series line blanketing for the n=2..12 transitions plus
photoelectric continuum absorption below the Lyman limit (912 A), as one
broadcast expression over a wavelength tensor.  The masked branch is
evaluated everywhere and discarded by `torch.where`, as `jnp.where`
does in the JAX module (it may overflow where it is masked off).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kde import _as, _input_device

__all__ = ["madau_teff", "madau_tau"]

# Lyman-series n->1 wavelengths [A] (n = 2..12) and Madau line coefficients.
_LY_LINES = np.array([1216.0, 1026.0, 973.0, 950.0, 938.1, 931.0, 926.5,
                      923.4, 921.2, 919.6, 918.4])
_LY_COEFFS = np.array([0.0037, 0.00177, 0.00106, 0.000584, 0.00044, 0.00040,
                       0.00037, 0.00035, 0.00033, 0.00032, 0.00031])
_LY_LIMIT = 912.0


def madau_tau(wave, z, device=None):
    """Total Madau optical depth at observed wavelengths `wave` [A] for
    sources at redshift `z`: a scalar, or a tensor that broadcasts
    against `wave` (e.g. (Nz, 1) against (Nwave,)).  Tensors stay on
    their device; host arrays go to the card unless `device` is named
    (`ops.kde._input_device`).  The result has `wave`'s dtype."""
    wave = _as(wave, _input_device(wave, z, device=device))
    z = torch.as_tensor(z, dtype=wave.dtype, device=wave.device)
    lines = torch.as_tensor(_LY_LINES, dtype=wave.dtype, device=wave.device)
    coeffs = torch.as_tensor(_LY_COEFFS, dtype=wave.dtype,
                             device=wave.device)
    w = wave[..., None]  # broadcast against the trailing line axis

    # Line blanketing (reddening.py:23-56): each line contributes
    # coeff * (wave/line)^3.46 blueward of its redshifted position.
    zline = lines * (1.0 + z)[..., None]
    tau1 = torch.where(w < zline, coeffs * (w / lines) ** 3.46,
                       0.0).sum(dim=-1)

    # Photoelectric continuum below the Lyman limit (reddening.py:59-78).
    xc = wave / _LY_LIMIT
    xem = 1.0 + z
    tau2 = (0.25 * xc**3 * (xem**0.46 - xc**0.46)
            + 9.4 * xc**1.5 * (xem**0.18 - xc**0.18)
            - 0.7 * xc**3 * (xc**-1.32 - xem**-1.32)
            - 0.023 * (xem**1.68 - xc**1.68))
    tau2 = torch.where(wave < _LY_LIMIT * xem, tau2.clamp_min(0.0), 0.0)

    return tau1 + tau2


def madau_teff(wave, z, device=None):
    """Effective IGM transmission exp(-tau) (reddening.py:81-95)."""
    return torch.exp(-madau_tau(wave, z, device=device))
