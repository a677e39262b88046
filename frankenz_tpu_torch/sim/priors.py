"""
P(z, t, m) population priors for mock-survey generation.

Port of `frankenz_tpu.sim.priors` (reference `frankenz/priors.py`:
`pmag` :27, `_bpz_prior` :76, `bpz_pt_m` :136, `bpz_pz_tm` :183): a copy
in host NumPy, line for line, so that the simulator draws what the JAX
package draws from the same generator.  The magnitude prior is the
Rykoff-style number count P(m) ~ m^alpha exp(-(m/(maglim-gamma))^beta);
the redshift/type prior is the BPZ prior of Benitez (2000) with Table-1
coefficients for three broad morphological classes (E/S0, Spiral, Irr),
vectorized over magnitudes and redshifts, with P(z|t,m) normalized as a
PMF over the reference's 1000-point z in [0, 15] grid and bilinearly
interpolated in (m, z) from the (1000, 1000, 3) table that `BPZPrior`
builds once.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pmag", "bpz_prior", "BPZPrior", "bpz_pt_m", "bpz_pz_tm"]

# BPZ Table 1 (Benitez 2000) coefficients for [E/S0, Spiral, Irr].
_BPZ_A = np.array([2.465, 1.806, 0.906])
_BPZ_Z0 = np.array([0.431, 0.390, 0.0626])
_BPZ_KM = np.array([0.0913, 0.0636, 0.123])
_BPZ_KT = np.array([0.450, 0.147])
_BPZ_F0 = np.array([0.35, 0.5, 0.15])  # fractions at m=20

_MGRID_N = 1000
_ZGRID_N = 1000
_MBOUNDS = (20.0, 32.0)
_ZBOUNDS = (0.0, 15.0)


def pmag(mag, maglim=25.0, mbounds=(10.0, 28.0), alpha=15.0, beta=2.0,
         gamma=1.0, Npoints=1000, **kwargs):
    """Magnitude prior P(m) ~ m^alpha exp(-(m/(maglim-gamma))^beta).

    Normalized by trapezoidal integration over an `Npoints` grid spanning
    `mbounds` and evaluated by linear interpolation, exactly as the
    reference does (priors.py:27-73) so inverse-CDF draws agree.
    """
    mag = np.asarray(mag, dtype=float)
    mgrid = np.linspace(mbounds[0], mbounds[1], Npoints)
    pgrid = mgrid**alpha * np.exp(-((mgrid / (maglim - gamma)) ** beta))
    pgrid /= np.trapezoid(pgrid, mgrid)
    return np.interp(mag, mgrid, pgrid)


def bpz_prior(m, zgrid, mbounds=_MBOUNDS, zbounds=_ZBOUNDS):
    """BPZ joint prior pieces at magnitudes `m` over redshift grid `zgrid`.

    Vectorized over `m` (priors.py:76-133 computes one magnitude at a
    time).  Returns ``(p, f_t)`` with shapes (..., Nz, 3) and (..., 3):
    ``p[..., iz, t] = P(z_iz, t | m)`` (normalized as a PMF over `zgrid`
    per type, times the type fraction) and ``f_t`` the type fractions.
    """
    m = np.clip(np.asarray(m, dtype=float), mbounds[0], mbounds[1])
    dm = (m - mbounds[0])[..., None]  # (..., 1)
    zgrid = np.asarray(zgrid, dtype=float)

    zmt = np.clip(_BPZ_Z0 + _BPZ_KM * dm, zbounds[0], zbounds[1])  # (...,3)
    f_t = np.empty(dm.shape[:-1] + (3,))
    f_t[..., :2] = _BPZ_F0[:2] * np.exp(-_BPZ_KT * dm)
    f_t[..., 2] = 1.0 - f_t[..., :2].sum(axis=-1)

    zt_a = np.power(zgrid[:, None], _BPZ_A)  # (Nz, 3)
    ratio = np.clip(zt_a / (zmt[..., None, :] ** _BPZ_A), 0.0, 700.0)
    p = zt_a * np.exp(-ratio)  # (..., Nz, 3)
    p = p / p.sum(axis=-2, keepdims=True)
    p = p * f_t[..., None, :]
    return p, f_t


class BPZPrior:
    """Lazily built BPZ prior tables matching the reference's cache.

    (priors.py:166-178, 220-232): a (1000, 3) type-fraction table over
    m in [20, 32] and a (1000, 1000, 3) P(z | t, m) table over
    (m, z) in [20, 32] x [0, 15], both bilinearly interpolated.
    """

    _instance = None

    def __init__(self):
        self.mgrid = np.linspace(_MBOUNDS[0], _MBOUNDS[1], _MGRID_N)
        self.zgrid = np.linspace(_ZBOUNDS[0], _ZBOUNDS[1], _ZGRID_N)
        p, f = bpz_prior(self.mgrid, self.zgrid)
        self.pz_table = p  # (Nm, Nz, 3)
        self.ft_table = f  # (Nm, 3)

    @classmethod
    def instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def _m_weights(self, m):
        # Non-finite magnitudes (e.g. negative noisy fluxes) clip to the
        # faint bound rather than poisoning the integer cast below.
        m = np.nan_to_num(np.asarray(m, dtype=float), nan=_MBOUNDS[1],
                          posinf=_MBOUNDS[1], neginf=_MBOUNDS[0])
        m = np.clip(m, _MBOUNDS[0], _MBOUNDS[1])
        x = (m - _MBOUNDS[0]) / (self.mgrid[1] - self.mgrid[0])
        i0 = np.clip(np.floor(x).astype(int), 0, _MGRID_N - 2)
        return i0, x - i0

    def pt_m(self, t, m):
        """P(t | m), vectorized over `m` (and broadcastable `t`)."""
        i0, w = self._m_weights(m)
        ft = (1.0 - w)[..., None] * self.ft_table[i0] \
            + w[..., None] * self.ft_table[i0 + 1]
        return np.take_along_axis(
            ft, np.broadcast_to(np.asarray(t)[..., None], ft.shape[:-1]
                                + (1,)).astype(int), axis=-1)[..., 0]

    def pz_tm_grid(self, t, m):
        """P(z | t, m) over the full z table grid: shape (..., Nz).

        One linear interpolation in m of the cached table — the building
        block for vectorized inverse-CDF redshift sampling.
        """
        i0, w = self._m_weights(m)
        t = np.asarray(t, dtype=int)
        lo = self.pz_table[i0, :, t]  # advanced indexing -> (..., Nz)
        hi = self.pz_table[i0 + 1, :, t]
        return (1.0 - w)[..., None] * lo + w[..., None] * hi

    def pz_tm(self, z, t, m):
        """P(z | t, m) — bilinear in (m, z), matching the reference's
        RegularGridInterpolator on the cached table."""
        grid = self.pz_tm_grid(t, m)  # (..., Nz)
        z = np.clip(np.asarray(z, dtype=float), _ZBOUNDS[0], _ZBOUNDS[1])
        dz = self.zgrid[1] - self.zgrid[0]
        x = z / dz
        j0 = np.clip(np.floor(x).astype(int), 0, _ZGRID_N - 2)
        wz = x - j0
        lo = np.take_along_axis(grid, j0[..., None], axis=-1)[..., 0]
        hi = np.take_along_axis(grid, (j0 + 1)[..., None], axis=-1)[..., 0]
        return (1.0 - wz) * lo + wz * hi


def bpz_pt_m(t, m, **kwargs):
    """Functional BPZ P(t | m) (priors.py:136-180), vectorized."""
    t = np.asarray(t, dtype=int)
    if np.any(t < 0) or np.any(t > 2):
        raise ValueError("t must be between 0 and 2 (inclusive).")
    return BPZPrior.instance().pt_m(t, m)


def bpz_pz_tm(z, t, m, **kwargs):
    """Functional BPZ P(z | t, m) (priors.py:183-235), vectorized."""
    t = np.asarray(t, dtype=int)
    if np.any(t < 0) or np.any(t > 2):
        raise ValueError("t must be between 0 and 2 (inclusive).")
    return BPZPrior.instance().pz_tm(z, t, m)
