"""A mock photometric survey: filter curves, SED templates and the BPZ
prior, turned into model photometries and magnitude-limited catalogs.

The benchmark's own copy of the arithmetic of frankenz's simulator
(`simulate.py`, `priors.py`, `reddening.py`), written again from the
configuration and the data files under ``benchmark/data``:

* each template's f_lambda read from its file, turned into f_nu and
  normalized at `wnorm`; its flux in each band is the trapezoid in
  frequency of T(nu) / nu x the Madau (1995) IGM transmission x the
  redshifted f_nu (interpolated in asinh f_nu over log wavelength), over
  the same trapezoid of T(nu) / nu.  These band fluxes are tabulated once
  a run on a grid of redshifts (`z_table`) and read by linear
  interpolation;
* an object: its reference-band magnitude drawn from the number counts
  P(m) ~ m^alpha exp(-(m / (maglim - gamma))^beta), its broad type from
  the BPZ fractions P(t | m), a template of that type uniformly, and its
  redshift from the BPZ P(z | t, m) ~ z^a exp(-(z / zm)^a), zm = z0 +
  km (m - 20) (Benitez 2000, Table 1), cut to the configuration's range;
  each draw by the inverse of the distribution's CDF, tabulated on a
  grid; then Gaussian noise at the survey's 1-sigma flux depth in every
  band (sky-limited: the same error at every magnitude, so the
  signal-to-noise falls with the magnitude), with a calibration floor, a
  fixed share of the flux, added in quadrature.

Every random number is drawn on the device from a `torch.Generator`, in a
few large calls, so one seed gives one catalog on one kind of device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

C_MS = 299792458.0
AB_UJY = 23.9  # m_AB = 23.9 - 2.5 log10(f / uJy)

# Madau (1995) Lyman-series wavelengths [A] (n = 2..12) and coefficients.
_LY_LINES = (1216.0, 1026.0, 973.0, 950.0, 938.1, 931.0, 926.5, 923.4,
             921.2, 919.6, 918.4)
_LY_COEFFS = (0.0037, 0.00177, 0.00106, 0.000584, 0.00044, 0.00040,
              0.00037, 0.00035, 0.00033, 0.00032, 0.00031)
_LY_LIMIT = 912.0
# Quantile tables: points in u of each inverse CDF, and the magnitudes
# (over the drawn range) at which P(z | t, m) is tabulated.
_NU = 4097
_MROWS = 161


def igm_transmission(wave, z):
    """exp(-tau) of the Madau (1995) IGM at observed wavelengths `wave`
    [A] for sources at `z` (tensors that broadcast)."""
    tau = torch.zeros_like(wave + z)
    for line, coeff in zip(_LY_LINES, _LY_COEFFS):
        tau = tau + torch.where(wave < line * (1.0 + z),
                                coeff * (wave / line) ** 3.46, 0.0)
    xc = wave / _LY_LIMIT
    xem = 1.0 + z
    cont = (0.25 * xc ** 3 * (xem ** 0.46 - xc ** 0.46)
            + 9.4 * xc ** 1.5 * (xem ** 0.18 - xc ** 0.18)
            - 0.7 * xc ** 3 * (xc ** -1.32 - xem ** -1.32)
            - 0.023 * (xem ** 1.68 - xc ** 1.68))
    tau = tau + torch.where(wave < _LY_LIMIT * xem, cont.clamp_min(0.0), 0.0)
    return torch.exp(-tau)


def _interp(x, xp, fp):
    """`np.interp(x, xp, fp)` for a tensor `x` of any shape (xp sorted)."""
    k = xp.shape[0]
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, k - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    w = ((x - x0) / (x1 - x0)).clamp(0.0, 1.0)
    return f0 + w * (f1 - f0)


def _read_list(path):
    with open(path) as f:
        return [line.split() for line in f if line.strip()]


class Survey:
    """Filters, templates and prior of a configuration's ``survey`` and
    ``prior`` sections, with the band fluxes of every template
    tabulated over redshift on `device`."""

    def __init__(self, config, device, root):
        sv, self.prior = config["survey"], config["prior"]
        self.device = torch.device(device)
        root = Path(root)
        filters = _read_list(root / sv["filters"])
        names = [f[1] for f in filters]
        self.ref = names.index(sv["ref_band"])
        m5 = np.array([float(f[3]) for f in filters])
        # 1-sigma flux depth [uJy] from the 5-sigma limiting magnitude.
        self.depth = torch.as_tensor(10 ** (-0.4 * (m5 - AB_UJY)) / 5.0,
                                     dtype=torch.float64, device=self.device)
        self.calib_floor = float(sv["calib_floor"])
        self._tables = {}
        tlist = _read_list(root / sv["templates"])
        types = [t[2] for t in tlist]
        order = list(dict.fromkeys(types))  # broad types, as listed
        self.ttype = np.array([order.index(t) for t in types])
        self.ntemplates = len(tlist)
        zt = sv["z_table"]
        self.z_hi = float(zt["hi"])
        self.z_n = int(zt["n"])
        z = torch.linspace(0.0, self.z_hi, self.z_n, dtype=torch.float64,
                           device=self.device)
        fdir = (root / sv["filters"]).parent
        tdir = (root / sv["templates"]).parent
        curves = [np.loadtxt(fdir / f[2]).T for f in filters]
        seds = []
        for row in tlist:
            wave, flam = np.loadtxt(tdir / row[3]).T
            fnu = wave ** 2 * flam
            fnu = fnu / np.interp(float(sv["wnorm"]), wave, fnu)
            seds.append((torch.as_tensor(np.log(wave), device=self.device),
                         torch.as_tensor(np.arcsinh(fnu), device=self.device)))
        table = torch.zeros((self.ntemplates, self.z_n, len(filters)),
                            dtype=torch.float64, device=self.device)
        for b, (fw, ft) in enumerate(curves):
            fw = torch.as_tensor(fw, device=self.device)
            # T(nu) / nu over the curve's samples, nu = c / lambda.
            tn = torch.as_tensor(ft, device=self.device) * 1e-10 * fw / C_MS
            dnu = torch.diff(C_MS / (1e-10 * fw))
            den = 0.5 * (dnu * (tn[1:] + tn[:-1])).sum()
            q = torch.log(fw)[None, :] - torch.log1p(z)[:, None]
            seen = tn * igm_transmission(fw[None, :], z[:, None])
            for t, (lw, afnu) in enumerate(seds):
                y = seen * torch.sinh(_interp(q, lw, afnu))
                table[t, :, b] = 0.5 * (dnu * (y[:, 1:] + y[:, :-1])).sum(1) \
                    / den
        self.table = table

    def fluxes(self, tmpl, z, weights=None):
        """Band fluxes (N, F) of templates `tmpl` (N,) at redshifts `z`
        (N,), normalized at `wnorm`; with `weights` (N,), the mixture
        ``(1 - w) tmpl + w (tmpl + 1)`` of neighbouring templates."""
        x = (z / (self.z_hi / (self.z_n - 1))).clamp(0, self.z_n - 1)
        j0 = x.floor().long().clamp(max=self.z_n - 2)
        w = (x - j0)[:, None]
        lo = self.table[tmpl, j0]
        hi = self.table[tmpl, j0 + 1]
        f = (1.0 - w) * lo + w * hi
        if weights is not None:
            t1 = (tmpl + 1).clamp(max=self.ntemplates - 1)
            g = (1.0 - w) * self.table[t1, j0] + w * self.table[t1, j0 + 1]
            f = (1.0 - weights[:, None]) * f + weights[:, None] * g
        return f

    def at_mag(self, flux, mag):
        """`flux` scaled so that its reference band reads magnitude `mag`."""
        ref = 10 ** (-0.4 * (mag - AB_UJY))
        return flux / flux[:, self.ref:self.ref + 1] * ref[:, None]

    # -- the prior ------------------------------------------------------
    def _quantiles(self, x, pdf):
        """(..., _NU) inverse CDF of `pdf` (..., len(x)) by the trapezoid,
        at u = 0, 1/(_NU - 1), ..., 1."""
        pdf = np.atleast_2d(pdf)
        cdf = np.concatenate([np.zeros((pdf.shape[0], 1)), np.cumsum(
            0.5 * (pdf[:, 1:] + pdf[:, :-1]) * np.diff(x), axis=1)], axis=1)
        cdf /= cdf[:, -1:]
        u = np.linspace(0.0, 1.0, _NU)
        out = np.empty((len(cdf), _NU))
        for r, c in enumerate(cdf):
            # The first point where the CDF reaches u, so that stretches
            # where the density is 0 take no draw.
            i = np.clip(np.searchsorted(c, u, side="left"), 1, len(x) - 1)
            c0, c1 = c[i - 1], c[i]
            w = np.where(c1 > c0, (u - c0) / np.where(c1 > c0, c1 - c0, 1.0),
                         0.0)
            out[r] = x[i - 1] + np.clip(w, 0.0, 1.0) * (x[i] - x[i - 1])
        return out

    def _lookup(self, table, row, u):
        """Linear interpolation in u of the quantile rows `row` of
        `table` (R, _NU)."""
        x = u * (_NU - 1)
        k = x.floor().long().clamp(max=_NU - 2)
        w = x - k
        return (1.0 - w) * table[row, k] + w * table[row, k + 1]

    def _prior_tables(self, mag, zrange):
        """The quantile tables of P(m) over `mag` and of P(z | t, m) over
        `zrange` on a grid of magnitudes: (qm (1, _NU), qz (3 _MROWS,
        _NU), the grid)."""
        key = (tuple(mag), tuple(zrange))
        if key in self._tables:
            return self._tables[key]
        pr, dev = self.prior, self.device
        pm = pr["pmag"]
        mgrid = np.linspace(mag[0], mag[1], 1001)
        pdf = mgrid ** pm["alpha"] * np.exp(
            -(mgrid / (pm["maglim"] - pm["gamma"])) ** pm["beta"])
        qm = torch.as_tensor(self._quantiles(mgrid, pdf), device=dev)
        mrow = np.linspace(mag[0], mag[1], _MROWS)
        zgrid = np.linspace(zrange[0], zrange[1], 1001)
        a = np.asarray(pr["a"])[:, None, None]
        zm = (np.asarray(pr["z0"])[:, None, None] + np.asarray(pr["km"])
              [:, None, None] * (np.clip(mrow, pr["m0"], pr["m_hi"])
                                 - pr["m0"])[None, :, None])
        pz = zgrid[None, None, :] ** a * np.exp(-np.minimum(
            (zgrid[None, None, :] / zm) ** a, 700.0))
        qz = torch.as_tensor(self._quantiles(zgrid, pz.reshape(-1, len(
            zgrid))), device=dev)
        self._tables[key] = qm, qz, mrow
        return self._tables[key]

    def draw(self, g, n, mag, zrange):
        """(mag, template, z) of `n` objects from the prior, magnitudes in
        `mag` and redshifts in `zrange`, from generator `g`."""
        pr, dev = self.prior, self.device
        qm, qz, mrow = self._prior_tables(mag, zrange)
        u = torch.rand((n, 4), generator=g, device=dev, dtype=torch.float64)
        m = self._lookup(qm, torch.zeros(n, dtype=torch.long, device=dev),
                         u[:, 0])
        # P(t | m): the first types' fractions decay from m0; the last
        # takes the rest.
        f0 = torch.as_tensor(pr["f0"], dtype=torch.float64, device=dev)
        kt = torch.as_tensor(pr["kt"], dtype=torch.float64, device=dev)
        dm = (m.clamp(pr["m0"], pr["m_hi"]) - pr["m0"])[:, None]
        frac = f0[None, :-1] * torch.exp(-kt[None, :] * dm)
        cum = torch.cumsum(frac, dim=1)
        btype = (u[:, 1:2] > cum).sum(1)
        # A template of that type, uniformly.
        counts = np.bincount(self.ttype, minlength=len(pr["f0"]))
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        order = torch.as_tensor(np.argsort(self.ttype, kind="stable"),
                                device=dev)
        cnt = torch.as_tensor(counts, device=dev)[btype]
        pos = torch.as_tensor(first, device=dev)[btype] + torch.minimum(
            (u[:, 2] * cnt).long(), cnt - 1)
        tmpl = order[pos]
        # P(z | t, m) from the quantile row of the nearest grid magnitude.
        im = ((m - mag[0]) / (mrow[1] - mrow[0])).round().long().clamp(
            0, _MROWS - 1)
        z = self._lookup(qz, btype * _MROWS + im, u[:, 3])
        return m, tmpl, z

    def observe(self, g, flux):
        """`flux` with Gaussian noise, and the errors: (obs, err), (N, F).
        The error is each band's 1-sigma depth and the calibration floor
        (``survey.calib_floor`` of the flux) in quadrature."""
        floor = float(self.calib_floor) * flux.abs()
        err = torch.sqrt(self.depth[None, :] ** 2 + floor ** 2)
        noise = torch.randn(flux.shape, generator=g, device=self.device,
                            dtype=torch.float64)
        return flux + err * noise, err
