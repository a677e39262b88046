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

``fit`` checkpoints its saved-fit prefix every ``checkpoint_every``
batches and resumes from it (`resume_fit_rows`, `utils.checkpoint`).
``fit_predict(mesh=)`` splits every batch over the devices of a
`parallel.Mesh`, each shard running the single-device route on its
device.  Not ported: the TPU-specific dispatch crossovers of the JAX
fitter.
"""

from __future__ import annotations

import functools
import os
from concurrent import futures
from typing import NamedTuple

import numpy as np
import torch

from ..ops import fused as _fused
from ..ops import kde as _kde
from ..ops import likelihood as _like
from ..ops import summarize as _summ
from ..parallel import mesh as _mesh
from ..utils import checkpoint as _ckpt
from ..utils.metrics import metrics as _metrics
from ..utils.progress import progress_iter
from ..utils.tracing import span, spanned

__all__ = ["BruteForce", "default_batch_size", "default_fused_batch_size",
           "resume_fit_rows"]


def resume_fit_rows(obj, resume, checkpoint_file, ndata,
                    checkpoint_every=None):
    """Restore a mid-fit checkpoint onto `obj`; returns the rows done.

    Shared by every fitter's batch-checkpointing fit loop.  It also
    validates the save plan first: `checkpoint_every` without a file
    fails before the first batch, not at the first save.
    """
    _ckpt.validate_plan(checkpoint_every, checkpoint_file)
    if not resume:
        return 0
    if not checkpoint_file:
        raise ValueError("resume=True requires checkpoint_file")
    if not _ckpt.exists(checkpoint_file):
        return 0
    _ckpt.restore(checkpoint_file, obj)
    done = int(getattr(obj, "_fit_rows_done", 0) or 0)
    if obj.NDATA != ndata:
        raise ValueError(
            f"checkpoint was taken for NDATA={obj.NDATA}, resuming "
            f"fit has ndata={ndata}")
    return done


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


class _Readback(NamedTuple):
    """A shard's outputs on their way to the host arrays: `slot` the
    pdf, lmap and levid host tensors (pinned staging on CUDA, its copies
    done once `event` has; the outputs themselves on the CPU, `event`
    None) and the first `m` of their rows go to row `j0`."""
    slot: list
    event: object
    j0: int
    m: int


# A store task copies at least this many bytes: a smaller record is one
# task, a larger one splits into a task a worker.
_STORE_LEAST_BYTES = 4 << 20


@functools.cache
def _store_pool():
    """The store workers and their number, made on the first pooled store:
    a thread for each CPU this process may use but the launching thread's,
    at most 8."""
    n = min(8, max(1, len(os.sched_getaffinity(0)) - 1))
    return futures.ThreadPoolExecutor(n, thread_name_prefix="fz-store"), n


def _row_ranges(m, row_bytes, workers):
    """`m` rows in at most `workers` contiguous ranges of at least
    `_STORE_LEAST_BYTES` each (one range where the rows hold less)."""
    n = max(1, min(workers, m * row_bytes // _STORE_LEAST_BYTES))
    step = -(-m // n)
    return [(a, min(a + step, m)) for a in range(0, m, step)]


def _store_rows(host, rec, src, a, b):
    """A store worker's task: rows `a:b` of a record's slot (`src`, its
    NumPy views) into the host arrays at row ``rec.j0 + a``, once the
    record's copies are done."""
    with span("readback.wait"):
        rec.event.synchronize()
    with span("readback.store"):
        for h, t in zip(host, src):
            h[rec.j0 + a:rec.j0 + b] = t[a:b]


def _join(tasks):
    """Wait for every store task of `tasks` (span ``readback.join``), then
    raise the first exception a worker met."""
    if not tasks:
        return
    with span("readback.join"):
        futures.wait(tasks)
        for t in tasks:
            t.result()


class _HostArrays(tuple):
    """A `_stream` call's host arrays ``(pdf, lmap, levid)`` and the
    shard copies on their way to them: `pending`, the `_Readback`s that
    `_finish_shard` started and `_drain_shard` has not handed on yet,
    and `free`, the staging slots handed to the store workers, each with
    its store tasks, to be filled again once those have finished."""

    def __new__(cls, arrays):
        self = super().__new__(cls, arrays)
        self.pending, self.free = [], []
        return self

    def take(self, m):
        """The first free slot of at least `m` rows, once its stores have
        finished; None where no slot holds `m` rows."""
        k = next((i for i, (s, _) in enumerate(self.free)
                  if s[0].shape[0] >= m), None)
        if k is None:
            return None
        slot, tasks = self.free.pop(k)
        _join(tasks)
        return slot

    def join(self):
        """Wait for every store still running: the arrays are whole."""
        _join([t for _, tasks in self.free for t in tasks])
        self.free = [(s, []) for s, _ in self.free]


def _copied_bytes(src, dst):
    """Bytes of `dst`, made from `src` (a host array or a tensor) by
    `torch.as_tensor` or `.to`, where that copied it onto a card: 0 on
    the CPU, and 0 where `.to` handed `src` back (it was there already)."""
    if dst.device.type == "cpu" or dst is src:
        return 0
    return dst.numel() * dst.element_size()


def _bf_lprob(d, de, dm, models, models_err, models_mask, lprob_func=None,
              lprob_args=None, lprob_kwargs=None):
    """One batch's log-posterior grids: `fit`'s per-batch step and the
    plain route's (the counterpart of `_bf_lprob_jit`)."""
    func = lprob_func or _like.logprob
    return func(d, de, dm, models, models_err, models_mask,
                *(lprob_args or ()), **(lprob_kwargs or {}))


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
        return _bf_lprob(d, de, dm, self.models, self.models_err,
                         self.models_mask, lprob_func, lprob_args,
                         lprob_kwargs)

    @spanned("fitter.kernel_G")
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
        (``lprob_kwargs={"free_scale": True, "return_scale": True}``).

        With ``checkpoint_every=N`` the saved fits (a consistent prefix)
        are written to `checkpoint_file` every N batches
        (`utils.checkpoint`); ``resume=True`` restores an existing
        checkpoint and continues from the first incomplete batch, giving
        the uninterrupted results bit for bit.
        """
        data = np.atleast_2d(np.asarray(data))
        data_err = np.atleast_2d(np.asarray(data_err))
        data_mask = np.atleast_2d(np.asarray(data_mask))
        ndata = data.shape[0]
        if batch_size is None:
            batch_size = default_batch_size(self.NMODEL)
        done = resume_fit_rows(self, resume, checkpoint_file, ndata,
                               checkpoint_every)
        if not done:
            self._alloc_fits(ndata, track_scale, fit_dtype)
        self._fit_rows_done = done
        nb = 0
        with _metrics.timer("bruteforce.fit",
                            items=(ndata - done) * self.NMODEL,
                            item_counter="chi2_pair_evals",
                            cuda=self.device.type == "cuda"):
            for i0, n in progress_iter(_batch_slices(ndata, batch_size),
                                       total=ndata, label="Fitting object",
                                       sizes=True, verbose=verbose):
                if i0 + n <= done:
                    continue
                sl = slice(i0, i0 + n)
                res = self._lprob(lprob_func, lprob_args, lprob_kwargs,
                                  self._tensor(data[sl]),
                                  self._tensor(data_err[sl]),
                                  self._tensor(data_mask[sl]))
                self._store_fits(sl, res)
                self._fit_rows_done = i0 + n
                nb += 1
                if checkpoint_every and nb % checkpoint_every == 0:
                    _ckpt.save(checkpoint_file, self)
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
            pdf, lm, lv = _kde.lnprob_pdf(
                self._tensor(logwt[sl].astype(np.float32)), G, wt_thresh,
                cdf_thresh)
            pdfs[sl] = _kde.norm_rows(pdf).cpu().numpy()
            lmap[sl] = lm.cpu().numpy()
            levid[sl] = lv.cpu().numpy()
        if return_gof:
            return pdfs, (lmap, levid)
        return pdfs

    @spanned("fitter.fit_predict")
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

        With `mesh` (a `parallel.Mesh`) each batch, its size rounded up
        to a multiple of ``mesh.size``, splits into equal row blocks, one
        a shard, and each shard runs the route above on its device.  The
        last rows pad to a multiple of ``mesh.size`` with data 0, errors
        1 and mask 0; ``full_mask`` is read from the unpadded mask.  Every
        shard of a batch is launched from this thread before any is read
        back, and the fused routes read nothing back inside a call (the
        models' band order is sorted once a device), so shards on
        distinct cards can overlap.  In the cdf mode the shards run the
        plain composition, as the JAX fitter does under a mesh: each
        builds its (rows, Nmodel) grids, where one device's call runs the
        fused cdf kernels.  `save_fits` and `track_scale` raise under
        `mesh`, and so does ``use_fused=True`` in the cdf mode.  A
        one-shard mesh gives the single-device result bit for bit.

        The call runs in the span ``fitter.fit_predict`` and counts
        ``fitter.calls`` (`utils.tracing`, `utils.metrics`; `_stream`
        names the rest).
        """
        _metrics.count("fitter.calls")
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
        explicit_fused = use_fused is True
        if use_fused is None:
            use_fused = eligible
        elif use_fused and not eligible:
            raise ValueError("use_fused=True requires the default lprob "
                             "pipeline (no custom lprob_func/args, no "
                             "save_fits/track_scale/return_scale)")
        devices = (self.device,)
        if mesh is not None:
            _mesh.check_mesh(mesh)
            cdf_mode = wt_thresh is None and cdf_thresh is not None
            if explicit_fused and cdf_mode:
                raise ValueError(
                    "use_fused=True with cdf_thresh selection is not "
                    "supported under mesh=; the sharded cdf path runs the "
                    "plain composition (pass use_fused=None/False)")
            if save_fits or track_scale:
                raise ValueError("mesh-sharded fit_predict streams PDFs "
                                 "only; save_fits/track_scale are "
                                 "unsupported (run fit() for stored "
                                 "grids)")
            use_fused = bool(use_fused) and not cdf_mode
            devices = mesh.devices
        _metrics.count("pdf_stacks", ndata)
        if batch_size is None:
            batch_size = (default_fused_batch_size(ndata, len(grid))
                          if use_fused else default_batch_size(self.NMODEL))
        if use_fused:
            out = self._fit_predict_fused(
                data, data_err, data_mask, G, lprob_kwargs or {},
                wt_thresh, cdf_thresh, batch_size, devices, verbose,
                _post_setup)
        else:
            out = self._fit_predict_plain(
                data, data_err, data_mask, G, lprob_func, lprob_args,
                lprob_kwargs, wt_thresh, cdf_thresh, batch_size, devices,
                save_fits, track_scale, verbose, _post_setup)
        pdfs, lmap, levid = out
        if return_gof:
            return pdfs, (lmap, levid)
        return pdfs

    @spanned("fitter.stream")
    def _stream(self, data, data_err, data_mask, G, dtype, devices,
                batch_size, post_setup, step, verbose):
        """Run every batch over `devices`, one equal row block a shard,
        and gather host arrays (JAX's `_fit_predict_sharded` on a mesh).

        The batch size rounds up to a multiple of ``len(devices)`` and
        the catalog pads to one, with data 0, errors 1 and mask 0 (as the
        JAX fitter pads, frankenz_tpu/models/bruteforce.py:747-754); on
        one device neither changes anything.  The catalog (as `dtype`;
        None keeps it), the models and G go once to each distinct device.
        `step(rep, sl) -> (pdf, lmap, levid)` runs one shard's rows `sl`
        of its device's copies `rep`.  A batch's shards are all launched,
        then normalized, mapped by the `post_setup` hook and their copies
        to the host started (`_finish_shard`); only then are the previous
        batch's shards handed to the store workers (`_drain_shard`), so
        the host's store of one batch overlaps the card's work on the
        next and this thread's launches.  A batch's copies go into the
        staging slots that the batch before the previous one filled, once
        their stores have finished.  Every shard is stored before the
        call returns (`_drain_pending`).  Returns the host arrays and the
        hook.

        Spans: ``fitter.stage`` (the upload) and in it ``stage.card``
        (one a distinct device), ``fitter.batch`` (each batch),
        ``fitter.launch`` (each shard's `step`), `_finish_shard`'s and
        `_drain_shard`'s; counters ``fitter.batches``, ``fitter.shards``,
        ``fitter.pad_rows``, ``stage.cards`` (on a mesh: the distinct
        devices staged) and ``stage.bytes`` (what the stage copies onto a
        card: the catalog from the host, the models and G where that card
        did not hold them; nothing on the CPU)."""
        ndata, ndev = data.shape[0], len(devices)
        batch_size = -(-batch_size // ndev) * ndev
        npad = (-ndata) % ndev
        _metrics.count("fitter.pad_rows", npad)
        cat = [np.pad(a, ((0, npad), (0, 0)), constant_values=v)
               for a, v in ((data, 0.0), (data_err, 1.0), (data_mask, 0.0))]

        models = (self.models, self.models_err, self.models_mask)

        def stage(dev):
            with span("stage.card"):
                rep = dict(cat=[torch.as_tensor(a, dtype=dtype, device=dev)
                                for a in cat],
                           models=[t.to(dev) for t in models], G=G.to(dev))
                _metrics.count("stage.bytes", sum(
                    _copied_bytes(s, t) for s, t in zip(
                        (*cat, *models, G),
                        (*rep["cat"], *rep["models"], rep["G"]))))
            return rep

        with span("fitter.stage"):
            reps = _mesh.per_device(devices, stage)
        if ndev > 1:
            _metrics.count("stage.cards", len(dict.fromkeys(devices)))
        post, width = ((None, G.shape[1]) if post_setup is None
                       else post_setup(ndata, batch_size))
        host = _HostArrays((np.zeros((ndata, width), np.float32),
                            np.zeros(ndata, np.float32),
                            np.zeros(ndata, np.float32)))
        for i0, n in progress_iter(_batch_slices(ndata + npad, batch_size),
                                   total=ndata + npad,
                                   label="Fitting object", sizes=True,
                                   verbose=verbose):
            per = n // ndev
            _metrics.count("fitter.batches")
            _metrics.count("fitter.shards", ndev)
            with span("fitter.batch"):
                outs = []
                for k, rep in enumerate(reps):
                    with span("fitter.launch"):
                        outs.append((i0 + k * per, step(rep, slice(
                            i0 + k * per, i0 + (k + 1) * per))))
                done, host.pending = host.pending, []
                for j0, out in outs:
                    self._finish_shard(host, j0, out, post)
                for rec in done:
                    self._drain_shard(host, rec)
        self._drain_pending(host)
        return host, post

    @staticmethod
    @spanned("fitter.finish_shard")
    def _finish_shard(host, j0, out, post):
        """Normalize a shard's PDFs, apply `post`, and start the copy of
        its rows that are not padding to the host: appends to
        ``host.pending`` (`_HostArrays`) the `_Readback` that
        `_drain_shard` stores at row `j0` of the host arrays.  On CUDA
        the copies go, on the current stream of the shard's device and
        without waiting, into a slot of ``host.free`` that holds them,
        once its stores have finished (span ``readback.join``), or else
        into new pinned tensors, and an event marks their end; on the
        CPU the record holds the outputs themselves.  Spans
        ``readback.normalize`` and ``readback.copy``; the bytes copied
        count in ``readback.bytes``."""
        pdf, lmap, levid = out
        m = min(pdf.shape[0], host[1].shape[0] - j0)
        if m <= 0:
            return
        with span("readback.normalize"):
            pdf = _kde.norm_rows(pdf)
            if post is not None:
                pdf = post(pdf, j0)
        got = [t[:m] for t in (pdf, lmap, levid)]
        event = None
        with span("readback.copy"):
            if pdf.device.type == "cuda":
                slot = host.take(m) or [
                    torch.empty((pdf.shape[0], *t.shape[1:]),
                                dtype=t.dtype, pin_memory=True)
                    for t in got]
                for s, t in zip(slot, got):
                    s[:m].copy_(t, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(pdf.device))
            else:
                slot = got
        _metrics.count("readback.bytes",
                       sum(t.numel() * t.element_size() for t in got))
        host.pending.append(_Readback(slot, event, j0, m))

    @staticmethod
    @spanned("fitter.drain_shard")
    def _drain_shard(host, rec):
        """Store a `_finish_shard` record into the host arrays, its rows
        at row ``rec.j0``.  A record with pinned staging (an `event`, on
        CUDA) goes to the store workers (`_store_pool`) and its slot at
        once to ``host.free`` with their tasks: each waits for the
        copies (span ``readback.wait``) and stores one row range of the
        slot (``readback.store``), the ranges split so that the workers
        fault the fresh pages of a large record in parallel; counted in
        ``readback.pooled``.  On the CPU the rows are stored here, in the
        same spans."""
        if rec.event is None:
            with span("readback.wait"):
                pass
            with span("readback.store"):
                for h, t in zip(host, rec.slot):
                    h[rec.j0:rec.j0 + rec.m] = t[:rec.m].numpy()
            return
        pool, workers = _store_pool()
        src = [t.numpy() for t in rec.slot]
        row_bytes = sum(t[0].nbytes for t in src)
        tasks = [pool.submit(_store_rows, host, rec, src, a, b)
                 for a, b in _row_ranges(rec.m, row_bytes, workers)]
        host.free.append((rec.slot, tasks))
        _metrics.count("readback.pooled")

    @classmethod
    def _drain_pending(cls, host):
        """Store every record of ``host.pending`` (`_drain_shard`) and wait
        for the store workers (`_HostArrays.join`)."""
        done, host.pending = host.pending, []
        for rec in done:
            cls._drain_shard(host, rec)
        host.join()

    @staticmethod
    def _fused_kw(lprob_kwargs, wt_thresh, cdf_thresh, full_mask):
        """`fused_fit_pdf`'s keywords for the lprob keywords given."""
        return dict(dim_prior=lprob_kwargs.get("dim_prior", True),
                    ignore_model_err=lprob_kwargs.get("ignore_model_err",
                                                      False),
                    free_scale=lprob_kwargs.get("free_scale", False),
                    wt_thresh=wt_thresh,
                    cdf_thresh=cdf_thresh if wt_thresh is None else None,
                    full_mask=full_mask,
                    # As the JAX fitter (frankenz_tpu/models/
                    # bruteforce.py:837-838): the lprob's own keywords,
                    # its defaults.
                    scale_ltol=float(lprob_kwargs.get("ltol", 1e-4)),
                    scale_max_iter=int(lprob_kwargs.get("max_iter", 100)))

    def _fit_predict_fused(self, data, data_err, data_mask, G, lprob_kwargs,
                           wt_thresh, cdf_thresh, batch_size, devices,
                           verbose, post_setup=None):
        """Stream object batches through `ops.fused_fit_pdf`, each shard
        on its device (`_stream`); the catalog is uploaded once and
        sliced on the device.  ``full_mask`` is read from the unpadded
        mask.  In the cdf mode each shard's validity flag is read with
        its results, and flagged shards run again afterwards with
        ``cdf_exact=True``: their undetermined cuts are found by
        bisection on the same kernels (where the JAX fitter reruns them
        through the XLA sort, frankenz_tpu/models/bruteforce.py:852-880)."""
        kw = self._fused_kw(lprob_kwargs, wt_thresh, cdf_thresh,
                            self._full_mask and bool(np.all(data_mask == 1)))
        kw["defer_cdf_check"] = True
        # The routes past the screened one read the models in band order:
        # sorted once a device (`model_bands`), not in every batch's call.
        banded = _fused.fused_route(**{k: kw[k] for k in (
            "full_mask", "dim_prior", "free_scale", "wt_thresh",
            "cdf_thresh")}) != "screened"
        flagged = []

        def run(rep, sl, **extra):
            if banded and "band" not in rep:
                rep["band"] = _fused.model_bands(*rep["models"], rep["G"])
            d, de, dm = (t[sl] for t in rep["cat"])
            return _fused.fused_fit_pdf(d, de, dm, *rep["models"], rep["G"],
                                        band=rep.get("band"),
                                        **{**kw, **extra})

        def step(rep, sl):
            pdf, lmap, levid, ok = run(rep, sl)
            flagged.append((rep, sl, ok))
            return pdf, lmap, levid

        host, post = self._stream(data, data_err, data_mask,
                                  G.to(torch.float32).contiguous(),
                                  torch.float32, devices, batch_size,
                                  post_setup, step, verbose)
        self.cdf_reruns = 0
        for rep, sl, ok in flagged:
            if bool(ok):
                continue
            self.cdf_reruns += 1
            _metrics.count("cdf_reruns")
            with span("fitter.cdf_rerun"):
                self._finish_shard(host, sl.start, run(
                    rep, sl, defer_cdf_check=False, cdf_exact=True), post)
                self._drain_pending(host)
        return host

    def _fit_predict_plain(self, data, data_err, data_mask, G, lprob_func,
                           lprob_args, lprob_kwargs, wt_thresh, cdf_thresh,
                           batch_size, devices, save_fits, track_scale,
                           verbose, post_setup=None):
        """The plain composition (`ops.kde.lnprob_pdf`), each shard on
        its device (`_stream`; the counterpart of the JAX XLA path).
        `save_fits` runs on one device only (`fit_predict` refuses it
        under a mesh)."""
        if save_fits:
            self._alloc_fits(data.shape[0], track_scale)

        def step(rep, sl):
            d, de, dm = (t[sl] for t in rep["cat"])
            res = _bf_lprob(d, de, dm, *rep["models"], lprob_func,
                            lprob_args, lprob_kwargs)
            if save_fits:
                self._store_fits(sl, res)
            return _kde.lnprob_pdf(res[2], rep["G"], wt_thresh, cdf_thresh)

        return self._stream(data, data_err, data_mask, G, None, devices,
                            batch_size, post_setup, step, verbose)[0]

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
