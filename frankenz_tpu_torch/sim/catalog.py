"""Regenerated stand-in for the stripped SDSS DR13 spectroscopic catalog.

Port of `frankenz_tpu.sim.catalog`: the same catalog from the same seed
(the draws are the JAX module's, on the host; the synthesis runs on
`device`), cached under the port's own `frankenz_tpu_torch/data/
generated/` with the JAX module's file names.

The reference ships `data/SDSS_DR13_FRANKZ_hoyleb_0.fits` for its
real-data demos and benchmarks, but that file is not distributed.  This
module regenerates a deterministic mock equivalent at the same scale
from the packaged SDSS filters + CWW templates + BPZ prior
(`MockSurvey('sdss', 'cww+', 'bpz')`), so benchmarks and demo workflows
exercise photometry with realistic color-redshift structure and
magnitude-limited noise instead of uniform-random fluxes.

Catalog rows mirror the demo-2 usage: observed fluxes (uJy) at the
survey 1-sigma depths, flux errors, masks, plus the true (z, type,
template, refmag) parameters.  Everything is seeded — two calls with the
same (nobj, seed) give identical catalogs — and cached as .npz so
repeated runs skip the synthesis.
"""

from __future__ import annotations

import os

import numpy as np

from .survey import MockSurvey, _device

__all__ = ["make_sdss_mock", "sdss_model_grid"]

_CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "generated")


def make_sdss_mock(nobj=110_000, seed=13, cache=True, zbounds=(0, 7),
                   mbounds=(14.0, 19.4), survey="sdss", templates="cww+",
                   prior="bpz", device="cuda"):
    """Deterministic SDSS-like mock catalog (DR13 stand-in).

    Returns a dict with `phot` / `phot_err` / `phot_mask`
    ((Nobj, 5) uJy fluxes, 1-sigma errors, 0/1 masks) and the truth
    columns `redshifts`, `types`, `templates`, `refmags`.  Objects with
    non-finite photometry (reference bad-phot handling,
    simulate.py:849-852) are dropped, so the returned catalog can be
    slightly smaller than `nobj`.

    `mbounds` defaults to the *spectroscopic* regime (r <~ 19.4, the
    DR13 main+BOSS magnitude range) rather than the photometric depth —
    the stripped reference catalog is a spectroscopic training sample,
    so photometry here is high-SNR with realistic color-z structure.
    """
    device = _device(device)
    bounds = (f"m{mbounds[0]:g}-{mbounds[1]:g}"
              f"_z{zbounds[0]:g}-{zbounds[1]:g}")
    cache_path = os.path.join(
        _CACHE, f"{survey}_{templates}_{prior}_{nobj}_{seed}_{bounds}.npz")
    if cache and os.path.exists(cache_path):
        with np.load(cache_path) as f:
            return {k: f[k] for k in f.files}

    ms = MockSurvey(survey=survey, templates=templates, prior=prior,
                    seed=seed, device=device)
    data = ms.make_mock(nobj, mbounds=mbounds, zbounds=zbounds,
                        verbose=False)
    ok = (np.isfinite(data["refmags"])
          & np.all(np.isfinite(data["phot_obs"]), axis=1)
          & np.all(np.isfinite(data["phot_true"]), axis=1))
    cat = {
        "phot": data["phot_obs"][ok].astype(np.float32),
        "phot_err": data["phot_err"][ok].astype(np.float32),
        "phot_mask": np.ones((int(ok.sum()), ms.NFILTER), np.float32),
        "redshifts": data["redshifts"][ok].astype(np.float32),
        "types": data["types"][ok].astype(np.int32),
        "templates": data["templates"][ok].astype(np.int32),
        "refmags": data["refmags"][ok].astype(np.float32),
    }
    if cache:
        os.makedirs(_CACHE, exist_ok=True)
        np.savez_compressed(cache_path, **cat)
    return cat


def sdss_model_grid(nz=201, zbounds=(0, 4), seed=13, survey="sdss",
                    templates="cww+", prior="bpz", mag_norm=None,
                    device="cuda"):
    """Flattened (Nz * Ntemplate) SDSS model grid for fitting the mock.

    Returns ``(models, models_err, models_mask, zlabels, tlabels)`` —
    the demo-2 pattern: synthesize every template at every grid
    redshift, normalize to a common reference magnitude (`mag_norm`,
    default 22 in the r band -> fluxes comparable to the catalog's), and
    attach zero model errors (noiseless grid).
    """
    ms = MockSurvey(survey=survey, templates=templates, prior=prior,
                    seed=seed, device=device)
    zgrid = np.linspace(zbounds[0], zbounds[1], nz)
    ms.make_model_grid(zgrid, verbose=False)
    flat, zz, tt = ms.flatten_grid()
    ref = ms.ref_filter
    mag_norm = 22.0 if mag_norm is None else float(mag_norm)
    flux_ref = 10 ** ((mag_norm - 23.9) / -2.5)
    with np.errstate(all="ignore"):
        flat = flat / flat[:, ref][:, None] * flux_ref
    ok = np.all(np.isfinite(flat), axis=1) & (flat[:, ref] > 0)
    flat = flat[ok].astype(np.float32)
    return (flat, np.zeros_like(flat), np.ones_like(flat),
            zz[ok].astype(np.float32), tt[ok].astype(np.int32))
