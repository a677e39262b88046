"""
Mock survey simulator: filters + SED templates + P(z,t,m) prior -> noisy
photometry and model grids.

Port of `frankenz_tpu.sim.survey` (reference `frankenz/simulate.py`:
`MockSurvey` :354, `draw_mag` :96, `draw_type_given_mag` :153,
`draw_redshift_given_type_mag` :203, `draw_ztm` :276, `make_model_grid`
:954).  Per object: draw (m, t, z) from the prior by inverse-CDF
sampling, redshift the template SED, attenuate with the Madau IGM
transmission, integrate through each filter curve in frequency space
(with the reference's asinh-transform interpolation), normalize to the
reference-band magnitude, and add Gaussian noise at the survey depths.

Two halves, as in the JAX module:

* **Sampling stays on the host**, line for line: the same
  `numpy.random.Generator` calls in the same order (`draw_mag`,
  `draw_types`, the per-type `rng.choice`, `draw_redshifts`, then
  `sample_phot`'s `rng.normal`), so one seed draws the same (m, t,
  template, z) and noise in both packages, bit for bit.
* **Synthesis runs on `device`** in float64 (the host arrays' dtype):
  every (z, template) pair is one row of a batched `torch.searchsorted`
  interpolation of the shifted template, then `sinh`, `madau_teff` and a
  trapezoid over the padded filter axis; the model grid is the same
  rows over the (z, template) product.  The curves are padded by the JAX
  module's rules (`_pad_to`), which keep the padded integrals exact, and
  rows are processed in chunks under `budget_bytes`.

The filter and SED libraries are read as files from the JAX package's
data directory (`frankenz_tpu/data/{filters,seds}`, found beside this
package); nothing of that package is imported.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.summarize import _interp
from . import priors as _priors
from .igm import madau_teff

__all__ = ["MockSurvey", "mag_err", "draw_mag", "draw_types",
           "draw_redshifts", "draw_ztm", "draw_type_given_mag",
           "draw_redshift_given_type_mag", "SURVEYS", "TEMPLATE_LIBRARIES",
           "PRIORS", "IGM_CURVES"]

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "frankenz_tpu", "data")

# Preset registries (simulate.py:26-48).
SURVEYS = {"cosmos": "COSMOS.list", "euclid": "Euclid.list",
           "hsc": "HSC.list", "lsst": "LSST.list", "sdss": "SDSS.list"}
REFMAGS = {"cosmos": "i+", "euclid": "VIS", "hsc": "i", "lsst": "r",
           "sdss": "r"}
TEMPLATE_LIBRARIES = {"brown": "BROWN.list", "cww+": "CWWSB4.list",
                      "polletta+": "POLLETTASB.list"}
PRIORS = {"bpz": (_priors.pmag, _priors.bpz_pt_m, _priors.bpz_pz_tm)}
IGM_CURVES = {"madau+99": madau_teff}

C_MS = 299792458.0  # speed of light [m/s]


def mag_err(mag, maglim, sigdet=5.0, params=(4.56, 1.0, 1.0)):
    """Rykoff et al. (2015) magnitude error vs a detection limit.

    sigma_m = (2.5/ln10) * sqrt((1 + Fnoise/F) / (F k t_eff)) with
    t_eff = exp(a + b (maglim - 21)) and Fnoise set so that the error at
    `maglim` corresponds to a `sigdet`-sigma detection.  (The reference's
    `mag_err` is dead code with undefined variables, simulate.py:86-90;
    this is the corrected form of the same model.)
    """
    a, b, k = params
    teff = np.exp(a + b * (np.asarray(maglim) - 21.0))
    F = 10 ** (-0.4 * (np.asarray(mag) - 22.5))
    Flim = 10 ** (-0.4 * (np.asarray(maglim) - 22.5))
    Fnoise = (Flim / sigdet) ** 2 * k * teff - Flim
    return 2.5 / np.log(10.0) * np.sqrt((1.0 + Fnoise / F) / (F * k * teff))


# ----------------------------------------------------------------------
# Vectorized inverse-CDF sampling (simulate.py:96-351)
# ----------------------------------------------------------------------

def _inverse_cdf_draw(u, pdf, xgrid):
    """Draw via the reference's left-padded inverse CDF (simulate.py:139-148).

    `pdf` is (..., N) over `xgrid` (N,); `u` uniforms broadcastable to
    pdf.shape[:-1].  The CDF is cumsum-normalized and left-padded with 0
    at x = xgrid[0] - 1e-5*range, then inverted by linear interpolation.
    """
    cdf = np.cumsum(pdf, axis=-1)
    cdf = np.concatenate([np.zeros(cdf.shape[:-1] + (1,)), cdf], axis=-1)
    cdf = cdf / cdf[..., -1:]
    lpad = 1e-5 * (xgrid[-1] - xgrid[0])
    x = np.concatenate([[xgrid[0] - lpad], xgrid])
    if cdf.ndim == 1:
        return np.interp(u, cdf, x)
    flat_u = np.reshape(u, (-1,))
    flat_cdf = np.reshape(cdf, (-1, cdf.shape[-1]))
    out = np.array([np.interp(ui, ci, x)
                    for ui, ci in zip(flat_u, flat_cdf)])
    return out.reshape(np.shape(u))


def draw_mag(nobj, pmag_fn, rng, pmag_kwargs=None, mbounds=(10, 28),
             npoints=1000):
    """Draw magnitudes from P(m) by inverse CDF (simulate.py:96-150)."""
    if mbounds[0] >= mbounds[1]:
        raise ValueError("mbounds {} incorrectly ordered".format(mbounds))
    pmag_kwargs = pmag_kwargs or {}
    mgrid = np.linspace(mbounds[0], mbounds[1], npoints)
    pdf = np.asarray(pmag_fn(mgrid, **pmag_kwargs))
    return _inverse_cdf_draw(rng.uniform(size=nobj), pdf, mgrid)


def draw_types(mags, rng, prior=None):
    """Draw morphological types from P(t | m), vectorized categorical.

    (simulate.py:153-200 draws per object through the interpolated
    fraction table; this evaluates the fractions for all magnitudes at
    once and inverts the categorical CDF with searchsorted.)
    """
    if prior is None:
        prior = _priors.BPZPrior.instance()
    i0, w = prior._m_weights(mags)
    ft = (1.0 - w)[:, None] * prior.ft_table[i0] \
        + w[:, None] * prior.ft_table[i0 + 1]  # (Nobj, 3)
    cdf = np.cumsum(ft, axis=-1)
    cdf /= cdf[:, -1:]
    u = rng.uniform(size=len(np.atleast_1d(mags)))
    return (cdf < u[:, None]).sum(axis=-1).astype(int)


def draw_redshifts(types, mags, rng, prior=None, zbounds=(0, 15),
                   npoints=1000):
    """Draw z from P(z | t, m) by vectorized inverse CDF.

    (simulate.py:203-273; the reference's zgrid has `npoints` points over
    `zbounds` — we interpolate the prior's cached table onto it so draws
    follow the same discretized PMF.)
    """
    if prior is None:
        prior = _priors.BPZPrior.instance()
    zgrid = np.linspace(zbounds[0], zbounds[1], npoints)
    pdfs = prior.pz_tm(zgrid[None, :], np.asarray(types)[:, None],
                       np.asarray(mags)[:, None])  # (Nobj, Nz)
    draws = _inverse_cdf_draw(rng.uniform(size=len(np.atleast_1d(types))),
                              pdfs, zgrid)
    return np.maximum(draws, 0.0)


def draw_type_given_mag(p_type_given_mag, mags, ntypes=3, rng=None,
                        ptm_kwargs=None, rstate=None):
    """Draw types from a P(t | m) *function* (simulate.py:153-200).

    Reference-compatible signature: `p_type_given_mag(t, m, **ptm_kwargs)`
    returns the probability of (integer) type `t` at magnitude `m`.  The
    per-type evaluations are vectorized over all magnitudes when the
    function allows (the preset `bpz_pt_m` does), falling back to a
    per-object loop otherwise; the augmented-CDF draw matches the
    reference's `int(interp(u, cdf, arange(-1, N)) + 1)` discretization.
    Returns an array (the reference yields a generator).
    """
    ptm_kwargs = ptm_kwargs or {}
    rng = rng if rng is not None else (rstate or np.random.default_rng())
    mags = np.atleast_1d(np.asarray(mags, dtype=float))
    nobj = len(mags)
    probs = np.empty((nobj, ntypes))
    try:
        for t in range(ntypes):
            col = np.asarray(p_type_given_mag(t, mags, **ptm_kwargs),
                             dtype=float)
            if col.shape != mags.shape:
                raise ValueError
            probs[:, t] = col
    except Exception:
        for i, m in enumerate(mags):
            probs[i] = [float(p_type_given_mag(t, m, **ptm_kwargs))
                        for t in range(ntypes)]
    cdf = np.cumsum(probs, axis=-1)
    cdf /= cdf[:, -1:]
    u = rng.uniform(size=nobj)
    return (cdf < u[:, None]).sum(axis=-1).astype(int)


def draw_redshift_given_type_mag(p_z_tm, types, mags, rng=None,
                                 pztm_kwargs=None, zbounds=(0, 15),
                                 npoints=1000, rstate=None):
    """Draw redshifts from a P(z | t, m) *function* (simulate.py:203-273).

    Reference-compatible signature: `p_z_tm(z=..., t=..., m=...,
    **pztm_kwargs)`.  Evaluated over the `npoints` z grid for all objects
    at once when the function broadcasts (the preset `bpz_pz_tm` does),
    falling back to per-object (then per-z) evaluation; draws by the
    reference's left-padded inverse CDF, clipped at 0.  Returns an array
    (the reference yields a generator).
    """
    pztm_kwargs = pztm_kwargs or {}
    if zbounds[0] >= zbounds[1]:
        raise ValueError("The values {0} in `zbounds` are incorrectly "
                         "ordered.".format(zbounds))
    rng = rng if rng is not None else (rstate or np.random.default_rng())
    types = np.atleast_1d(np.asarray(types))
    mags = np.atleast_1d(np.asarray(mags, dtype=float))
    nobj = len(types)
    zgrid = np.linspace(zbounds[0], zbounds[1], npoints)
    try:
        pdfs = np.asarray(p_z_tm(z=zgrid[None, :], t=types[:, None],
                                 m=mags[:, None], **pztm_kwargs),
                          dtype=float)
        if pdfs.shape != (nobj, npoints):
            raise ValueError
    except Exception:
        pdfs = np.empty((nobj, npoints))
        for i, (t, m) in enumerate(zip(types, mags)):
            try:
                row = np.asarray(p_z_tm(z=zgrid, t=t, m=m, **pztm_kwargs),
                                 dtype=float)
                if row.shape != zgrid.shape:
                    raise ValueError
            except Exception:
                row = np.array([p_z_tm(z=z, t=t, m=m, **pztm_kwargs)
                                for z in zgrid], dtype=float)
            pdfs[i] = row
    draws = _inverse_cdf_draw(rng.uniform(size=nobj), pdfs, zgrid)
    return np.maximum(draws, 0.0)


def draw_ztm(pmag, p_tm, p_ztm, nobj, pm_kwargs=None, ptm_kwargs=None,
             pztm_kwargs=None, mbounds=(10, 28), zbound=(0, 15),
             npoints=1000, ntypes=3, rng=None):
    """Joint (m, t, z) draw from prior *functions* (simulate.py:276-351).

    Reference-compatible signature (its own `draw_ztm` is dead code that
    forgets `Ntypes`; `ntypes` defaults to the BPZ prior's 3 classes).
    """
    rng = rng if rng is not None else np.random.default_rng()
    mags = draw_mag(nobj, pmag, rng, pmag_kwargs=pm_kwargs,
                    mbounds=mbounds, npoints=npoints)
    types = draw_type_given_mag(p_tm, mags, ntypes, rng=rng,
                                ptm_kwargs=ptm_kwargs)
    redshifts = draw_redshift_given_type_mag(p_ztm, types, mags, rng=rng,
                                             pztm_kwargs=pztm_kwargs,
                                             zbounds=zbound,
                                             npoints=npoints)
    return mags, types, redshifts


# ----------------------------------------------------------------------
# Flux synthesis (batched; simulate.py:819-836 / :994-1018)
# ----------------------------------------------------------------------

def _device(device):
    """`device` as a torch.device; ``"cuda"`` without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the simulator's synthesis runs on 'cuda' unless "
                           "a device is named, and no CUDA device is "
                           "available: pass device='cpu'")
    return device


def _synth_rows(tmpl_lw, tmpl_afnu, tidx, zs, filt_lw, filt_wave, filt_nu,
                filt_t, filt_norm):
    """Photometry of (z_r, template_r) rows: (R, F).

    The integrand of `_synth_grid` / `_synth_objects` in the JAX module
    for every row at once: the template's log-wavelength grid shifted by
    log1p(z) is the interpolation base, each filter's log-wavelengths
    the queries, then trapz(T / nu * IGM(lambda, z) * sinh(asinh f_nu),
    nu) / norm over the padded filter axis.
    """
    nf, lf = filt_t.shape
    z = zs[:, None]
    xp = tmpl_lw[tidx] + torch.log1p(z)                       # (R, Lt)
    q = filt_lw.reshape(1, nf * lf).expand(zs.shape[0], -1)
    fl = torch.sinh(_interp(q, xp, tmpl_afnu[tidx])).reshape(-1, nf, lf)
    te = madau_teff(filt_wave, zs[:, None, None])             # (R, F, Lf)
    y = filt_t / filt_nu * te * fl
    dx = torch.diff(filt_nu, dim=-1)
    return 0.5 * (dx * (y[..., 1:] + y[..., :-1])).sum(-1) / filt_norm


def _pad_to(arrs, mode):
    """Pad a list of (x, y) curves to a common length; stacked (N, L).

    mode='repeat' (filters): repeat the final (x, y) sample — the padded
    trapezoid segments have zero width, so integrals are bit-exact vs the
    unpadded curve.
    mode='extend' (templates, used as an interp base grid): continue x
    upward and repeat the final y, so queries beyond the real range clamp
    to y[-1] exactly like `np.interp` does on the unpadded grid.
    """
    L = max(len(x) for x, _ in arrs)
    xs, ys = [], []
    for x, y in arrs:
        pad = L - len(x)
        if pad:
            if mode == "repeat":
                x = np.concatenate([x, np.full(pad, x[-1])])
            else:
                step = max(abs(x[-1]) * 1e-3, np.diff(x).max())
                x = np.concatenate([x, x[-1] + step * np.arange(1, pad + 1)])
            y = np.concatenate([y, np.full(pad, y[-1])])
        xs.append(x)
        ys.append(y)
    return np.stack(xs), np.stack(ys)


class MockSurvey:
    """Mock survey: filters + templates + prior -> catalogs + model grids.

    Reference: `simulate.py:354-1021`.  Presets: surveys
    cosmos/euclid/hsc/lsst/sdss, template libraries brown/cww+/polletta+,
    prior 'bpz'.  The flux synthesis runs on `device`; ``"cuda"`` (the
    default) without a card raises: nothing falls back to the CPU.
    """

    def __init__(self, survey=None, templates=None, prior=None, rng=None,
                 seed=None, device="cuda"):
        self.device = _device(device)
        self.filters = None
        self.NFILTER = None
        self.ref_filter = None
        self.templates = None
        self.NTEMPLATE = None
        self.TYPES = None
        self.TYPE_COUNTS = None
        self.NTYPE = None
        self.TTYPE = None
        self.pm = None
        self.ptm = None
        self.pztm = None
        self.data = None
        self.models = None
        self.NOBJ = None
        self.rng = rng if rng is not None else np.random.default_rng(seed)
        self._synth_cache = None

        if survey is not None:
            if survey not in SURVEYS:
                raise ValueError("{} is not a valid survey preset"
                                 .format(survey))
            self.load_survey(survey)
            self.set_refmag(REFMAGS[survey])
        if templates is not None:
            if templates not in TEMPLATE_LIBRARIES:
                raise ValueError("{} is not a valid template preset"
                                 .format(templates))
            self.load_templates(templates)
        if prior is not None:
            if isinstance(prior, str) and prior not in PRIORS:
                raise ValueError("{} is not a valid prior preset"
                                 .format(prior))
            self.load_prior(prior)

    # ------------------------------------------------------------------
    # loading (simulate.py:444-628)
    # ------------------------------------------------------------------

    def load_survey(self, filter_list, path="", npoints=50000):
        """Parse a filter list + curves; compute depths and lambda_eff.

        Format (filters/README.txt): `index name path depth_mag5sig` per
        line; 1-sigma flux depth in uJy is 10**((m5 - 23.9)/-2.5)/5.
        """
        if filter_list in SURVEYS:
            path = os.path.join(_DATA, "filters", "")
            filter_list = SURVEYS[filter_list]
        self.filters = []
        fpaths = []
        with open(os.path.join(path, filter_list)) as f:
            for line in f:
                idx, name, fpath, depth = line.split()
                depth = float(depth)
                self.filters.append({
                    "index": int(idx), "name": name,
                    "depth_mag5sig": depth,
                    "depth_flux1sig": 10 ** ((depth - 23.9) / -2.5) / 5.0,
                })
                fpaths.append(fpath)
        self.NFILTER = len(self.filters)
        for fpath, fltr in zip(fpaths, self.filters):
            wave, trans = np.loadtxt(os.path.join(path, fpath)).T
            fltr["wavelength"] = wave
            fltr["transmission"] = trans
            fltr["frequency"] = C_MS / (1e-10 * wave)
            # Effective wavelength: exp(<ln lambda>_T) over ln(nu)
            # (simulate.py:497-509).
            nu = np.linspace(1.001 * C_MS / (wave.max() * 1e-10),
                             0.999 * C_MS / (wave.min() * 1e-10),
                             int(npoints))
            w2 = C_MS / nu
            tr = np.interp(1e10 * w2, wave, trans)
            fltr["lambda_eff"] = float(np.exp(
                np.trapezoid(tr * np.log(w2), np.log(nu))
                / np.trapezoid(tr, np.log(nu))) * 1e10)
        self._synth_cache = None

    def load_templates(self, template_list, path="", wnorm=7000.0):
        """Parse a template list + SEDs; f_lambda -> f_nu, normalize at
        the pivot wavelength `wnorm` (simulate.py:511-578)."""
        if template_list in TEMPLATE_LIBRARIES:
            path = os.path.join(_DATA, "seds", "")
            template_list = TEMPLATE_LIBRARIES[template_list]
        self.templates = []
        tpaths = []
        with open(os.path.join(path, template_list)) as f:
            for line in f:
                idx, name, ttype, tpath = line.split()
                self.templates.append({"index": int(idx), "name": name,
                                       "type": ttype})
                tpaths.append(tpath)
        self.NTEMPLATE = len(self.templates)

        ttypes = [t["type"] for t in self.templates]
        _, idx, counts = np.unique(ttypes, return_index=True,
                                   return_counts=True)
        self.TYPES = np.array(ttypes)[np.sort(idx)]
        self.TYPE_COUNTS = counts
        if len(self.TYPES) == 1:
            self.TYPES = np.arange(self.NTEMPLATE).astype(str)
            self.TYPE_COUNTS = np.ones(self.NTEMPLATE)
        self.NTYPE = len(self.TYPES)
        self.TTYPE = np.array([int(np.flatnonzero(self.TYPES == t)[0])
                               for t in ttypes])

        for tpath, tmp in zip(tpaths, self.templates):
            wave, flam = np.loadtxt(os.path.join(path, tpath)).T
            fnu = (wave * 1e-10) ** 2 / C_MS * (flam * 1e10)
            tmp["wavelength"] = wave
            tmp["frequency"] = C_MS / (1e-10 * wave)
            tmp["flambda"] = flam / np.interp(wnorm, wave, flam)
            tmp["fnu"] = fnu / np.interp(wnorm, wave, fnu)
        self._synth_cache = None

    def load_prior(self, prior):
        """Attach (P(m), P(t|m), P(z|t,m)) functions (simulate.py:580-598)."""
        if isinstance(prior, str):
            self.pm, self.ptm, self.pztm = PRIORS[prior]
        else:
            self.pm, self.ptm, self.pztm = prior

    def set_refmag(self, ref, mode="name"):
        """Select the reference filter by name/index/counter
        (simulate.py:600-628)."""
        if mode not in {"name", "index", "counter"}:
            raise ValueError("{} is not an allowed category.".format(mode))
        if mode == "counter":
            self.ref_filter = int(ref)
            return
        match = [i for i, f in enumerate(self.filters) if f[mode] == ref]
        if not match:
            raise ValueError("{} does not match any {} among the filters."
                             .format(ref, mode))
        self.ref_filter = match[0]

    # ------------------------------------------------------------------
    # synthesis engine
    # ------------------------------------------------------------------

    def _synth_arrays(self):
        """Padded float64 curves on the device: (t_lw, t_afnu, f_lw,
        f_wave, f_nu, f_t, norm)."""
        if self._synth_cache is None:
            t_lw, t_afnu = _pad_to(
                [(np.log(t["wavelength"]), np.arcsinh(t["fnu"]))
                 for t in self.templates], mode="extend")
            f_wave, f_t = _pad_to(
                [(f["wavelength"], f["transmission"])
                 for f in self.filters], mode="repeat")
            f_nu = C_MS / (1e-10 * f_wave)
            f_lw = np.log(f_wave)
            # Padded transmission is 0, so padded samples have zero
            # trapezoid weight -> norm is exact.
            norm = np.array([np.trapezoid(ft / fn, fn)
                             for ft, fn in zip(f_t, f_nu)])
            self._synth_cache = tuple(
                torch.tensor(a, dtype=torch.float64, device=self.device)
                for a in (t_lw, t_afnu, f_lw, f_wave, f_nu, f_t, norm))
        return self._synth_cache

    def _synth(self, zs, tidx, igm, rows_per_chunk):
        """`_synth_rows` over host (z, template) rows, `rows_per_chunk`
        at a time; a host (R, F) float64 array."""
        t_lw, t_afnu, f_lw, f_wave, f_nu, f_t, norm = self._synth_arrays()
        if not igm:
            f_wave = torch.full_like(f_wave, 1e30)  # teff(1e30 A) == 1
        out = np.zeros((len(zs), f_t.shape[0]))
        for s in range(0, len(zs), rows_per_chunk):
            sl = slice(s, s + rows_per_chunk)
            z = torch.tensor(zs[sl], dtype=torch.float64,
                             device=self.device)
            t = torch.tensor(tidx[sl], device=self.device)
            out[sl] = _synth_rows(t_lw, t_afnu, t, z, f_lw, f_wave, f_nu,
                                  f_t, norm).cpu().numpy()
        return out

    def synthesize_grid(self, redshifts, igm=True, budget_bytes=1 << 28):
        """(Nz, Ntemplate, Nfilter) fluxes for templates at `redshifts`.

        Exactly the reference integral (simulate.py:1004-1014): trapz in
        frequency of T(nu)/nu * IGM(lambda, z) * sinh(interp(ln lambda_f,
        ln lambda_t(1+z), asinh f_nu)), normalized by trapz(T/nu, nu).
        IGM attenuation can be disabled with ``igm=False``.

        Redshifts are processed in chunks (the JAX module's sizes) that
        keep the (Z, T, F, L) integrand intermediates under
        `budget_bytes` of device memory.
        """
        _, t_afnu, _, _, _, f_t, _ = self._synth_arrays()
        zs = np.atleast_1d(np.asarray(redshifts, dtype=float))
        ntm, lt = t_afnu.shape
        nf, lf = f_t.shape
        # Peak intermediates per redshift: the (T, Lt) shifted template
        # grids and the (T, F, Lf) filter integrands, times a safety
        # factor for temporaries.
        per_z = 6 * 8 * ntm * (lt + nf * lf)
        chunk = int(np.clip(budget_bytes // max(per_z, 1), 32, 8192))
        rows = self._synth(np.repeat(zs, ntm), np.tile(np.arange(ntm),
                                                       len(zs)),
                           igm, chunk * ntm)
        return rows.reshape(len(zs), ntm, nf)

    def synthesize_objects(self, redshifts, templates, igm=True,
                           budget_bytes=1 << 28):
        """(Nobj, Nfilter) fluxes for per-object (z, template) pairs.

        The catalog-path companion of `synthesize_grid`: each object
        integrates only its own template.  Chunked like
        `synthesize_grid`.
        """
        _, t_afnu, _, _, _, f_t, _ = self._synth_arrays()
        zs = np.atleast_1d(np.asarray(redshifts, dtype=float))
        tidx = np.atleast_1d(np.asarray(templates, dtype=np.int64))
        _, lt = t_afnu.shape
        nf, lf = f_t.shape
        per_obj = 6 * 8 * (lt + nf * lf)
        chunk = int(np.clip(budget_bytes // max(per_obj, 1), 256, 1 << 16))
        return self._synth(zs, tidx, igm, chunk)

    def make_model_grid(self, redshifts, red_fn="madau+99", verbose=True):
        """Model photometry grid over `redshifts` (simulate.py:954-1021).

        Stored under `self.models` as {'data': (Nz, Nt, Nf), 'zgrid': ...}.
        """
        del verbose  # one batched device pass; nothing to report
        phot = self.synthesize_grid(np.asarray(redshifts),
                                    igm=red_fn is not None)
        self.models = {"data": phot, "zgrid": np.asarray(redshifts)}
        return self.models

    # ------------------------------------------------------------------
    # catalog generation (simulate.py:630-952)
    # ------------------------------------------------------------------

    def sample_params(self, nobj, rng=None, mbounds=None, zbounds=(0, 15),
                      Nm=1000, Nz=1000, pm_kwargs=None, ptm_kwargs=None,
                      pztm_kwargs=None, verbose=True):
        """Draw (m, t, template, z) for `nobj` objects from the LOADED
        prior (simulate.py:630-761: types from `self.ptm`, redshifts from
        `self.pztm`, with `ptm_kwargs`/`pztm_kwargs` forwarded).

        The preset BPZ prior takes a vectorized table-interpolation fast
        path; any prior installed via `load_prior` goes through the
        reference-compatible function protocol (`draw_type_given_mag` /
        `draw_redshift_given_type_mag`).
        """
        del verbose
        rng = rng or self.rng
        if self.pm is None:
            raise ValueError("no prior loaded — call load_prior() first")
        pm_kwargs = dict(pm_kwargs or {})
        maglim = pm_kwargs.setdefault(
            "maglim", self.filters[self.ref_filter]["depth_mag5sig"])
        if mbounds is None:
            mbounds = (10, maglim + 2.5 * np.log10(5))

        mags = draw_mag(nobj, self.pm, rng, pmag_kwargs=pm_kwargs,
                        mbounds=mbounds, npoints=Nm)
        if self.ptm is _priors.bpz_pt_m and not ptm_kwargs:
            types = draw_types(mags, rng)
        else:
            types = draw_type_given_mag(self.ptm, mags, self.NTYPE,
                                        rng=rng, ptm_kwargs=ptm_kwargs)
        # Uniform template choice within each drawn type
        # (simulate.py:720-737).
        templates = np.empty(nobj, dtype=int)
        for i in range(self.NTYPE):
            sel = types == i
            pool = np.flatnonzero(self.TTYPE == i)
            templates[sel] = rng.choice(pool, size=int(sel.sum()))
        if self.pztm is _priors.bpz_pz_tm and not pztm_kwargs:
            redshifts = draw_redshifts(types, mags, rng, zbounds=zbounds,
                                       npoints=Nz)
        else:
            redshifts = draw_redshift_given_type_mag(
                self.pztm, types, mags, rng=rng, pztm_kwargs=pztm_kwargs,
                zbounds=zbounds, npoints=Nz)
        self.data = {"refmags": mags, "types": types,
                     "templates": templates, "redshifts": redshifts}
        self.NOBJ = nobj
        return self.data

    def sample_phot(self, red_fn="madau+99", rnoise_fn=None, rng=None,
                    verbose=True):
        """Noisy photometry for the sampled catalog (simulate.py:763-878).

        Synthesizes true fluxes per object via the vectorized engine
        (grouped by template), normalizes the reference band to the drawn
        magnitude, and adds Gaussian noise at the survey 1-sigma depths.
        """
        del verbose
        rng = rng or self.rng
        if self.data is None:
            raise ValueError("No mock data has been generated.")
        mags = self.data["refmags"]
        templates = self.data["templates"]
        redshifts = self.data["redshifts"]

        # Per-object gathered synthesis: each object integrates only its
        # own template (the reference groups by template,
        # simulate.py:819-836; a full (z, template) grid here would do
        # NTEMPLATE-x redundant integrals — 129x for the brown library).
        phot = self.synthesize_objects(redshifts, templates,
                                       igm=red_fn is not None)

        # Normalize to the reference magnitude (simulate.py:842-847).
        with np.errstate(all="ignore"):
            fluxes = 10 ** ((mags - 23.9) / -2.5)
            phot /= phot[:, self.ref_filter][:, None]
            phot *= fluxes[:, None]

        # Bad photometry handling (simulate.py:849-852).
        bad = np.unique(np.nonzero(~np.isfinite(phot))[0])
        self.data["refmags"][bad] = np.inf
        phot[bad] = -np.inf

        fnoise = np.tile([f["depth_flux1sig"] for f in self.filters],
                         (self.NOBJ, 1)).astype(float)
        if rnoise_fn is not None:
            fnoise = rnoise_fn(fnoise, rng=rng)
        with np.errstate(all="ignore"):
            phot_obs = rng.normal(phot, fnoise)

        self.data["phot_true"] = phot
        self.data["phot_obs"] = phot_obs
        self.data["phot_err"] = fnoise
        return self.data

    def make_mock(self, nobj, mbounds=None, zbounds=(0, 15), Nm=1000,
                  Nz=1000, pm_kwargs=None, ptm_kwargs=None,
                  pztm_kwargs=None, red_fn="madau+99",
                  rnoise_fn=None, rng=None, verbose=True):
        """sample_params + sample_phot (simulate.py:880-952)."""
        self.sample_params(nobj, rng=rng, mbounds=mbounds, zbounds=zbounds,
                           Nm=Nm, Nz=Nz, pm_kwargs=pm_kwargs,
                           ptm_kwargs=ptm_kwargs, pztm_kwargs=pztm_kwargs,
                           verbose=verbose)
        self.sample_phot(red_fn=red_fn, rnoise_fn=rnoise_fn, rng=rng,
                         verbose=verbose)
        return self.data

    def flatten_grid(self):
        """(Nz*Nt, Nf) model array + matching z/template labels.

        Convenience for feeding `make_model_grid` output to the fitters
        (the demos do this reshape by hand).
        """
        if self.models is None:
            raise ValueError("No model grid has been generated.")
        grid = self.models["data"]
        nz, nt, nf = grid.shape
        zz = np.repeat(self.models["zgrid"], nt)
        tt = np.tile(np.arange(nt), nz)
        return grid.reshape(nz * nt, nf), zz, tt
