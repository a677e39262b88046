"""
BruteForce fitter: every model against every datum, fit -> PDF per batch.

Port of `frankenz_tpu.models.bruteforce` (reference
`frankenz/bruteforce.py`): object batches go through

  lprob_func -> (B, M) log-posteriors -> lmap, levid (max, logsumexp)
             -> thresholded weights -> weights @ G -> (B, Ngrid) PDFs

and, on the default lprob pipeline, through the fused route's CUDA
kernels (`ops.fused.fused_fit_pdf`: the full-mask pair, or the general
lnl kernels for masked photometry, the Normal likelihood, free scale,
the cdf mode and no weight threshold at all), so the (B, M) grid is
never built.  ``track_scale`` and ``save_fits`` take the plain
composition, which stores the grids.
`BruteForce` is a plain class holding the model set on one device; it
has nothing to train, so it is not an `nn.Module`.

Not ported yet: ``mesh=`` sharding and ``checkpoint_every`` / ``resume``
(they raise `NotImplementedError`), the gathered-KDE paths, and the
TPU-specific dispatch crossovers of the JAX fitter.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fused as _fused
from ..ops import kde as _kde
from ..ops import likelihood as _like
from ..ops import summarize as _summ
from ..utils.metrics import metrics as _metrics
from ..utils.progress import progress_iter

__all__ = ["BruteForce", "default_batch_size", "default_fused_batch_size"]


def default_batch_size(nmodel, budget_elems=1 << 26):
    """Object-batch size keeping the (B, M) grid near `budget_elems`."""
    b = max(64, int(budget_elems // max(nmodel, 1)))
    return int(min(1 << 14, 1 << (b.bit_length() - 1)))


def default_fused_batch_size(ndata, ngrid, budget_elems=1 << 25):
    """Object-batch size of the fused path: bounded by the (B, Ngrid)
    PDF output (`budget_elems` float32 elements, padded to 128 columns
    as in the JAX package) and capped at 65536; small catalogs round up
    to the next power of two (>= 256)."""
    gp = -(-int(ngrid) // 128) * 128
    b = max(512, min(1 << 16, int(budget_elems) // gp))
    b = 1 << (b.bit_length() - 1)
    if ndata < b:
        b = min(b, max(256, 1 << max(int(ndata) - 1, 1).bit_length()))
    return int(b)


def _batch_slices(n, batch_size):
    for start in range(0, n, batch_size):
        yield start, min(batch_size, n - start)


class BruteForce:
    """Brute-force photo-z fitter over a fixed model set.

    Parameters
    ----------
    models, models_err, models_mask : array_like or Tensor (Nmodel, Nfilt)
        Model photometry, errors and 0/1 observation mask, kept on
        `device` (dtype kept; float64 stays float64 for the plain path).
    full_mask : bool, optional
        Declare the model mask all-ones (engages the full-mask kernels);
        read from `models_mask` when omitted.
    device : str or torch.device
        Where the model set lives and the fits run.  ``"cuda"`` without a
        card raises: nothing falls back to the CPU.
    """

    def __init__(self, models, models_err, models_mask, full_mask=None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BruteForce(device='cuda') needs a CUDA "
                               "device; none is available")
        self.models = self._tensor(models)
        self.models_err = self._tensor(models_err)
        self.models_mask = self._tensor(models_mask)
        if full_mask is None:
            full_mask = bool((self.models_mask == 1).all())
        self._full_mask = bool(full_mask)
        self.NMODEL, self.NDIM = self.models.shape
        self.NDATA = None
        self.fit_lnprior = None
        self.fit_lnlike = None
        self.fit_lnprob = None
        self.fit_Ndim = None
        self.fit_chi2 = None
        self.fit_scale = None
        self.fit_scale_err = None
        # Batches of the last fused cdf-mode fit_predict whose cut was
        # undetermined and ran again with the bisection cut.
        self.cdf_reruns = 0

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _tensor(self, x, dtype=None):
        """`x` on the fitter's device; host arrays are copied (they may be
        read-only views, e.g. of JAX arrays)."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _lprob(self, lprob_func, lprob_args, lprob_kwargs, d, de, dm):
        func = lprob_func or _like.logprob
        return func(d, de, dm, self.models, self.models_err,
                    self.models_mask, *(lprob_args or ()),
                    **(lprob_kwargs or {}))

    def _fp_metrics(self, ndata):
        """fit_predict telemetry: phase timer + pair-eval / stack counts."""
        _metrics.count("pdf_stacks", ndata)
        return _metrics.timer("bruteforce.fit_predict",
                              items=ndata * self.NMODEL,
                              item_counter="chi2_pair_evals",
                              cuda=self.device.type == "cuda")

    def _kernel_G(self, model_labels, model_label_errs, label_dict,
                  label_grid, dx=None, sig_thresh=5.0):
        """(Nmodel, Ngrid) row-normalized kernel matrix + the grid, on
        the fitter's device."""
        if label_dict is not None:
            y_idx, y_std_idx = label_dict.fit(np.asarray(model_labels),
                                              np.asarray(model_label_errs))
            G = _kde.kernel_matrix_dict(label_dict, y_idx, y_std_idx,
                                        device=self.device)
            return G, self._tensor(label_dict.grid)
        if label_grid is None:
            raise ValueError("`label_dict` or `label_grid` must be "
                             "specified.")
        grid = self._tensor(np.asarray(label_grid))
        G = _kde.kernel_matrix(self._tensor(np.asarray(model_labels)),
                               self._tensor(np.asarray(model_label_errs)),
                               grid, dx=dx, sig_thresh=sig_thresh)
        return G, grid

    @staticmethod
    def _fused_eligible(lprob_func, lprob_args, lprob_kwargs, track_scale,
                        save_fits):
        """The fused route covers the default lprob pipeline only."""
        if lprob_func is not None or lprob_args or track_scale or save_fits:
            return False
        kw = lprob_kwargs or {}
        if kw.get("return_scale"):
            return False
        return not (set(kw) - {"free_scale", "ignore_model_err",
                               "dim_prior", "return_scale", "ltol",
                               "max_iter"})

    # ------------------------------------------------------------------
    # public API (mirrors the reference surface)
    # ------------------------------------------------------------------

    def fit(self, data, data_err, data_mask, lprob_func=None,
            lprob_args=None, lprob_kwargs=None, track_scale=False,
            verbose=True, batch_size=None, checkpoint_every=None,
            checkpoint_file=None, resume=False, fit_dtype=np.float32):
        """Fit all models to all data; store the (Ndata, Nmodel) grids as
        host NumPy arrays (reference `bruteforce.py:66-125`).  With
        `track_scale`, `fit_scale` / `fit_scale_err` start at ones /
        zeros and hold the lprob's scales where it returns them
        (``lprob_kwargs={"free_scale": True, "return_scale": True}``)."""
        if checkpoint_every or resume:
            raise NotImplementedError(
                "checkpoint_every / resume are not ported yet "
                "(utils/checkpoint, ROADMAP queue 1)")
        data = np.atleast_2d(np.asarray(data))
        data_err = np.atleast_2d(np.asarray(data_err))
        data_mask = np.atleast_2d(np.asarray(data_mask))
        ndata = data.shape[0]
        if batch_size is None:
            batch_size = default_batch_size(self.NMODEL)
        self._alloc_fits(ndata, track_scale, fit_dtype)
        with _metrics.timer("bruteforce.fit", items=ndata * self.NMODEL,
                            item_counter="chi2_pair_evals",
                            cuda=self.device.type == "cuda"):
            for i0, n in progress_iter(_batch_slices(ndata, batch_size),
                                       total=ndata, label="Fitting object",
                                       sizes=True, verbose=verbose):
                sl = slice(i0, i0 + n)
                res = self._lprob(lprob_func, lprob_args, lprob_kwargs,
                                  self._tensor(data[sl]),
                                  self._tensor(data_err[sl]),
                                  self._tensor(data_mask[sl]))
                self._store_fits(sl, res)
        return self

    def _alloc_fits(self, ndata, track_scale=False, fit_dtype=np.float32):
        m, dt = self.NMODEL, np.dtype(fit_dtype)
        self.NDATA = ndata
        self.fit_lnprior = np.zeros((ndata, m), dt)
        self.fit_lnlike = np.zeros((ndata, m), dt)
        self.fit_lnprob = np.zeros((ndata, m), dt)
        self.fit_Ndim = np.zeros((ndata, m), np.int32)
        self.fit_chi2 = np.zeros((ndata, m), dt)
        self.fit_scale = np.ones((ndata, m), dt) if track_scale else None
        self.fit_scale_err = (np.zeros((ndata, m), dt) if track_scale
                              else None)

    def _store_fits(self, sl, res):
        lnprior, lnlike, lnprob, ndim, chi2 = res[:5]
        dt = self.fit_lnprob.dtype
        self.fit_lnprior[sl] = lnprior.cpu().numpy().astype(dt)
        self.fit_lnlike[sl] = lnlike.cpu().numpy().astype(dt)
        self.fit_lnprob[sl] = lnprob.cpu().numpy().astype(dt)
        self.fit_Ndim[sl] = ndim.cpu().numpy().astype(np.int32)
        self.fit_chi2[sl] = chi2.cpu().numpy().astype(dt)
        # (frankenz_tpu/models/bruteforce.py:344-347)
        for name, t in zip(("fit_scale", "fit_scale_err"), res[5:7]):
            if t is not None and getattr(self, name) is not None:
                getattr(self, name)[sl] = t.cpu().numpy().astype(dt)

    def predict(self, model_labels, model_label_errs, label_dict=None,
                label_grid=None, logwt=None, kde_args=None, kde_kwargs=None,
                return_gof=False, verbose=True, batch_size=None,
                wt_thresh=1e-3, cdf_thresh=2e-4):
        """Stored (or given) log-weights -> normalized label PDFs
        (reference `bruteforce.py:207-372`)."""
        if logwt is None:
            logwt = self.fit_lnprob
        if logwt is None:
            raise ValueError("Fits have not been computed and weights have "
                             "not been provided.")
        dx, sig_thresh, wt_thresh, cdf_thresh = _kde.resolve_kde_opts(
            kde_args, kde_kwargs, wt_thresh, cdf_thresh)
        G, _ = self._kernel_G(model_labels, model_label_errs, label_dict,
                              label_grid, dx=dx, sig_thresh=sig_thresh)
        G = G.to(torch.float32)
        logwt = np.atleast_2d(np.asarray(logwt))
        ndata = logwt.shape[0]
        if batch_size is None:
            batch_size = default_batch_size(self.NMODEL)
        pdfs = np.zeros((ndata, G.shape[1]), np.float32)
        lmap = np.zeros(ndata, np.float32)
        levid = np.zeros(ndata, np.float32)
        for i0, n in progress_iter(_batch_slices(ndata, batch_size),
                                   total=ndata, label="Generating PDF",
                                   sizes=True, verbose=verbose):
            sl = slice(i0, i0 + n)
            lwt = self._tensor(logwt[sl].astype(np.float32))
            lm = lwt.amax(dim=1)
            lv = torch.logsumexp(lwt, dim=1)
            pdf = _kde.kde_stack(torch.exp(lwt - lv[:, None]), G, wt_thresh,
                                 cdf_thresh)
            pdfs[sl] = _kde.norm_rows(pdf).cpu().numpy()
            lmap[sl] = lm.cpu().numpy()
            levid[sl] = lv.cpu().numpy()
        if return_gof:
            return pdfs, (lmap, levid)
        return pdfs

    def fit_predict(self, data, data_err, data_mask, model_labels,
                    model_label_errs, lprob_func=None, label_dict=None,
                    label_grid=None, kde_args=None, kde_kwargs=None,
                    lprob_args=None, lprob_kwargs=None, return_gof=False,
                    track_scale=False, verbose=True, save_fits=False,
                    batch_size=None, wt_thresh=1e-3, cdf_thresh=2e-4,
                    use_fused=None, mesh=None, _post_setup=None):
        """Fit + predict in one pass: posteriors -> weights -> PDFs
        (reference `bruteforce.py:374-631`), returning host NumPy arrays.

        ``use_fused=None`` (default) or True runs `ops.fused_fit_pdf` on
        eligible configurations (the default lprob with any of its
        `free_scale`, `ignore_model_err`, `dim_prior`, `ltol` and
        `max_iter` keywords; no `track_scale`, `save_fits` or
        `return_scale`): on CUDA its kernels, on the CPU their plain
        versions.  `ltol` and `max_iter` reach the kernels as the free
        scale's `scale_ltol` and `scale_max_iter`.  In the cdf mode a
        batch whose cut is undetermined runs again, its cut found by
        bisection on the same kernels (counted in ``self.cdf_reruns``).
        ``use_fused=False``, and ``use_fused=None`` on an ineligible
        configuration, run the plain composition (logprob, logsumexp,
        threshold, kde_stack) on the fitter's device.  `_post_setup`
        (internal, see `fit_summarize`) maps each normalized PDF batch
        on device before it is copied back.
        """
        if mesh is not None:
            raise NotImplementedError("mesh= sharding is not ported yet "
                                      "(parallel/, ROADMAP queue 1)")
        data = np.atleast_2d(np.asarray(data))
        data_err = np.atleast_2d(np.asarray(data_err))
        data_mask = np.atleast_2d(np.asarray(data_mask))
        ndata = data.shape[0]
        dx, sig_thresh, wt_thresh, cdf_thresh = _kde.resolve_kde_opts(
            kde_args, kde_kwargs, wt_thresh, cdf_thresh)
        G, grid = self._kernel_G(model_labels, model_label_errs, label_dict,
                                 label_grid, dx=dx, sig_thresh=sig_thresh)
        eligible = self._fused_eligible(lprob_func, lprob_args,
                                        lprob_kwargs, track_scale,
                                        save_fits)
        if use_fused is None:
            use_fused = eligible
        elif use_fused and not eligible:
            raise ValueError("use_fused=True requires the default lprob "
                             "pipeline (no custom lprob_func/args, no "
                             "save_fits/track_scale/return_scale)")
        with self._fp_metrics(ndata):
            if use_fused:
                if batch_size is None:
                    batch_size = default_fused_batch_size(ndata, len(grid))
                out = self._fit_predict_fused(
                    data, data_err, data_mask, G, lprob_kwargs or {},
                    wt_thresh, cdf_thresh, batch_size, verbose, _post_setup)
            else:
                if batch_size is None:
                    batch_size = default_batch_size(self.NMODEL)
                out = self._fit_predict_plain(
                    data, data_err, data_mask, G, lprob_func, lprob_args,
                    lprob_kwargs, wt_thresh, cdf_thresh, batch_size,
                    save_fits, track_scale, verbose, _post_setup)
        pdfs, lmap, levid = out
        if return_gof:
            return pdfs, (lmap, levid)
        return pdfs

    def _stream(self, ndata, batch_size, post, step, verbose):
        """Run `step(i0, n) -> (pdf, lmap, levid)` per batch, apply the
        post transform, and gather host arrays."""
        parts = []
        for i0, n in progress_iter(_batch_slices(ndata, batch_size),
                                   total=ndata, label="Fitting object",
                                   sizes=True, verbose=verbose):
            parts.append(self._finish_batch(step(i0, n), post, i0))
        return tuple(np.concatenate([p[k] for p in parts]).astype(
            np.float32, copy=False) for k in range(3))

    @staticmethod
    def _finish_batch(out, post, i0):
        """Normalize a batch's PDFs, apply `post`, copy to the host."""
        pdf_b, lmap_b, levid_b = out
        pdf_b = _kde.norm_rows(pdf_b)
        if post is not None:
            pdf_b = post(pdf_b, i0)
        return tuple(t.cpu().numpy() for t in (pdf_b, lmap_b, levid_b))

    def _fit_predict_fused(self, data, data_err, data_mask, G, lprob_kwargs,
                           wt_thresh, cdf_thresh, batch_size, verbose,
                           post_setup=None):
        """Stream object batches through `ops.fused_fit_pdf`; the catalog
        is uploaded once and sliced on the device.  In the cdf mode each
        batch's validity flag is read with its results, and flagged
        batches run again afterwards with ``cdf_exact=True``: their
        undetermined cuts are found by bisection on the same kernels
        (where the JAX fitter reruns them through the XLA sort,
        frankenz_tpu/models/bruteforce.py:852-880)."""
        ndata = data.shape[0]
        full_mask = self._full_mask and bool(np.all(data_mask == 1))
        d_all = self._tensor(data, torch.float32)
        de_all = self._tensor(data_err, torch.float32)
        dm_all = self._tensor(data_mask, torch.float32)
        G = G.to(torch.float32).contiguous()
        cdf_thresh = cdf_thresh if wt_thresh is None else None
        kw = dict(dim_prior=lprob_kwargs.get("dim_prior", True),
                  ignore_model_err=lprob_kwargs.get("ignore_model_err",
                                                    False),
                  free_scale=lprob_kwargs.get("free_scale", False),
                  wt_thresh=wt_thresh, cdf_thresh=cdf_thresh,
                  full_mask=full_mask, defer_cdf_check=True,
                  # As the JAX fitter (frankenz_tpu/models/bruteforce.py:
                  # 837-838): the lprob's own keywords, its defaults.
                  scale_ltol=float(lprob_kwargs.get("ltol", 1e-4)),
                  scale_max_iter=int(lprob_kwargs.get("max_iter", 100)))
        flagged = []

        def step(i0, n):
            sl = slice(i0, i0 + n)
            pdf, lmap, levid, ok = _fused.fused_fit_pdf(
                d_all[sl], de_all[sl], dm_all[sl], self.models,
                self.models_err, self.models_mask, G, **kw)
            flagged.append((i0, n, ok))
            return pdf, lmap, levid

        post = (None if post_setup is None
                else post_setup(ndata, batch_size)[0])
        pdfs, lmap, levid = self._stream(ndata, batch_size, post, step,
                                         verbose)
        self.cdf_reruns = 0
        kw.update(defer_cdf_check=False, cdf_exact=True)
        for i0, n, ok in flagged:
            if bool(ok):
                continue
            self.cdf_reruns += 1
            _metrics.count("cdf_reruns")
            sl = slice(i0, i0 + n)
            out = _fused.fused_fit_pdf(
                d_all[sl], de_all[sl], dm_all[sl], self.models,
                self.models_err, self.models_mask, G, **kw)
            pdfs[sl], lmap[sl], levid[sl] = self._finish_batch(out, post, i0)
        return pdfs, lmap, levid

    def _fit_predict_plain(self, data, data_err, data_mask, G, lprob_func,
                           lprob_args, lprob_kwargs, wt_thresh, cdf_thresh,
                           batch_size, save_fits, track_scale, verbose,
                           post_setup=None):
        """The plain composition, batch by batch, on the fitter's device
        (the counterpart of the JAX XLA path)."""
        ndata = data.shape[0]
        if save_fits:
            self._alloc_fits(ndata, track_scale)

        def step(i0, n):
            sl = slice(i0, i0 + n)
            res = self._lprob(lprob_func, lprob_args, lprob_kwargs,
                              self._tensor(data[sl]),
                              self._tensor(data_err[sl]),
                              self._tensor(data_mask[sl]))
            if save_fits:
                self._store_fits(sl, res)
            lnp = res[2]
            lmap = lnp.amax(dim=1)
            levid = torch.logsumexp(lnp, dim=1)
            pdf = _kde.kde_stack(torch.exp(lnp - levid[:, None]),
                                 G.to(lnp.dtype), wt_thresh, cdf_thresh)
            return pdf, lmap, levid

        post = (None if post_setup is None
                else post_setup(ndata, batch_size)[0])
        return self._stream(ndata, batch_size, post, step, verbose)

    def fit_summarize(self, data, data_err, data_mask, model_labels,
                      model_label_errs, label_dict=None, label_grid=None,
                      kde_args=None, kde_kwargs=None, lprob_func=None,
                      lprob_args=None, lprob_kwargs=None, verbose=True,
                      batch_size=None, wt_thresh=1e-3, cdf_thresh=2e-4,
                      use_fused=None, mesh=None, pkern="lorentz",
                      pkern_grid=None, summary_seed=0):
        """`fit_predict` + `pdfs_summarize`, with the summary computed on
        the device per batch: only the 21 packed columns (and the GOF
        metrics) are copied back.  The MC draw uses
        ``default_rng(summary_seed).random()`` per (padded) catalog row,
        as the JAX package does, so it does not depend on batching.

        Returns ``(PDFSummary of host arrays, (lmap, levid))``.
        """
        grid = _summ.label_grid_of(label_dict, label_grid)
        cols, gof = self.fit_predict(
            data, data_err, data_mask, model_labels, model_label_errs,
            lprob_func=lprob_func, label_dict=label_dict,
            label_grid=label_grid, kde_args=kde_args, kde_kwargs=kde_kwargs,
            lprob_args=lprob_args, lprob_kwargs=lprob_kwargs,
            return_gof=True, verbose=verbose, batch_size=batch_size,
            wt_thresh=wt_thresh, cdf_thresh=cdf_thresh,
            use_fused=use_fused, mesh=mesh,
            _post_setup=_summ.stream_summary_setup(
                grid, pkern, pkern_grid, summary_seed, device=self.device))
        return _summ.unpack_summary(cols), gof
