"""
NearestNeighbors (KMCkNN) fitter: Monte-Carlo ensemble kNN posteriors.

Port of `frankenz_tpu.models.knn` (reference `frankenz/knn.py`: class
NearestNeighbors :33, `_train_kdtrees` :158, `_fit` :281, `_predict`
:500, `fit_predict` :560).  K Monte-Carlo realizations of the noisy
models are mapped to feature space (luptitudes by default); each
datum's k nearest neighbours are found in every realization, the K*k
indices are merged into their first-seen union, and the exact posterior
is evaluated on that union only.

As in the JAX module, the search is brute force on the card and exact:

* the distance block ``|Y|^2 - 2 q @ Y^T + |q|^2`` (terms in that order,
  the product in full float32, `ops.kde.fp32_matmul`), or the
  elementwise sum for ``lp_norm=1``, per ensemble, in column chunks whose
  float32 block stays under `_TOPK_DIST_BYTES` (`_topk_chunk_cols`),
  with an exact merge of the per-chunk candidates;
* the k smallest distances of a row in `lax.top_k`'s order: ascending,
  the lowest index first among equal values (`_topk_smallest`;
  `torch.topk` documents no order among ties, so the order is imposed);
* the union: out-of-bound slots first remapped to per-slot sentinels
  (`_BIG + slot`), then a stable argsort, duplicates flagged, scattered
  back and compacted by a second stable argsort, with the reference's
  padding (index -99, lnprob -inf, chi2 +inf, knn.py:344-352);
* the posterior of each object against its own gathered union
  (`_gathered_lprob`) and the gathered KDE (`ops.kde`), both in the
  model set's dtype, run on the union's columns up to the widest union
  of the batch (rounded up to 128; the columns past it carry zero
  weight).

The Monte-Carlo draws stay on the host with the JAX module's
`numpy.random.Generator` calls (the ensembles in the constructor, each
padded batch's query jitter), so one seed gives both packages the same
draws.  ``approx=True`` runs the exact search: off the TPU the JAX
module's `lax.approx_max_k` returns what `lax.top_k` returns, so the
port's results are bit-equal to ``approx=False``.  `eps` and `leafsize`
are accepted and ignored (no trees).

Also here: the pieces the network fitters share, `_gathered_lprob`
(knn.py:76), `_gof_weights` (:115) and `stack_batches` (the body of
`NearestNeighbors._stack_batches`, :553).

``fit`` checkpoints its fit prefix every ``checkpoint_every`` batches
and resumes from it; skipped batches still draw their query jitter, so
the remaining draws line up.  ``fit_predict(mesh=)`` splits each batch,
its jitter drawn as in one device's call, over the devices of a
`parallel.Mesh`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kde as _kde
from ..ops import likelihood as _like
from ..ops import summarize as _summ
from ..ops import transforms as _tf
from ..parallel import mesh as _mesh
from ..utils import checkpoint as _ckpt
from ..utils.metrics import metrics as _metrics
from ..utils.progress import progress_iter
from .bruteforce import resume_fit_rows

__all__ = ["NearestNeighbors", "stack_batches"]

_BIG = 1 << 30

# Exact top-k columns per chunk, and bytes of one chunk's (B, cols)
# float32 distance block (the JAX module's ceilings, knn.py:55-72).
_TOPK_CHUNK = 1 << 20
_TOPK_DIST_BYTES = 2 << 30


def _topk_chunk_cols(nrows, k):
    """Exact-search chunk width: <= _TOPK_CHUNK columns AND
    <= _TOPK_DIST_BYTES per float32 distance block, never below k (the
    merge needs full per-chunk top-k's), a multiple of 128."""
    by_bytes = _TOPK_DIST_BYTES // (4 * max(int(nrows), 1)) // 128 * 128
    return min(_TOPK_CHUNK, max(int(k), by_bytes))


def _gathered_lprob(d, de, dm, idx, valid, models, models_err, models_mask,
                    *, lprob_spec):
    """Each object against its own gathered model subset.

    ``idx`` (B, J) model indices (invalid slots any value, masked by
    ``valid``); the models are gathered into (B, J, F) and the default
    `logprob` fits object b against its J models as one batch, with the
    single-object arithmetic of the JAX package's vmapped call.  A custom
    lprob function is mapped over the objects with `torch.func.vmap`.
    Returns the 7-tuple (lnprior, lnlike, lnprob, ndim, chi2, scale,
    scale_err) of (B, J) tensors, invalid slots padded; scale and
    scale_err are None when the lprob returns none.
    """
    lprob_func, lprob_args, kw_items = lprob_spec
    lprob_kwargs = dict(kw_items)
    safe = idx.clamp_min(0)
    m, me, mm = models[safe], models_err[safe], models_mask[safe]
    if lprob_func is None:
        res = _like.logprob(d, de, dm, m, me, mm, *lprob_args,
                            **lprob_kwargs)
        out = tuple(res[:5]) + (res.scale, res.scale_err)
    else:
        out = _vmapped_lprob(lprob_func, lprob_args, lprob_kwargs, d, de, dm,
                             m, me, mm)
    lnprior, lnlike, lnprob, ndim, chi2, scale, scale_err = out
    neg = torch.tensor(-torch.inf, dtype=lnprob.dtype, device=lnprob.device)
    lnprior = torch.where(valid, lnprior, neg)
    lnlike = torch.where(valid, lnlike, neg)
    lnprob = torch.where(valid, lnprob, neg)
    ndim = torch.where(valid, ndim, 0)
    chi2 = torch.where(valid, chi2, torch.inf)
    if scale is not None:
        scale = torch.where(valid, scale, 1.0)
        scale_err = torch.where(valid, scale_err, 0.0)
    return lnprior, lnlike, lnprob, ndim, chi2, scale, scale_err


def _vmapped_lprob(func, args, kwargs, d, de, dm, m, me, mm):
    """A custom lprob over the objects, one object and its (J, F) models
    per call, as `jax.vmap` maps it."""
    def one(x, xe, xm, mj, mej, mmj):
        return func(x[None], xe[None], xm[None], mj, mej, mmj, *args,
                    **kwargs)

    probe = one(d[0], de[0], dm[0], m[0], me[0], mm[0])
    has_scale = len(probe) > 5 and probe[5] is not None
    n_out = 7 if has_scale else 5

    def first(*a):
        res = one(*a)
        return tuple(res[k][0] for k in range(n_out))

    out = torch.func.vmap(first)(d, de, dm, m, me, mm)
    return tuple(out) + ((None, None) if not has_scale else ())


def _gof_weights(lnprob):
    """(lmap, levid, wt) of a log-weight grid (bruteforce.py:359-360).
    Subnormal weights are flushed to zero, as XLA flushes them in the
    JAX package (the cdf rule would otherwise keep a weight that JAX
    drops)."""
    lmap = lnprob.amax(dim=1)
    levid = torch.logsumexp(lnprob, dim=1)
    wt = torch.exp(lnprob - levid[:, None])
    return lmap, levid, torch.where(wt < torch.finfo(wt.dtype).tiny, 0.0,
                                    wt)


def _gathered_pdf(use_dict, lab, ngrid, idx, wt):
    """The gathered KDE of weights `wt` over model indices `idx`."""
    safe = idx.clamp_min(0)
    if use_dict:
        sigmas, widths, delta, full_pos, full_sig = lab
        return _kde._kde_stack_gathered(sigmas, widths, delta,
                                        full_pos[safe], full_sig[safe], wt,
                                        ngrid)
    labels, label_errs, grid, dx, sig_thresh = lab
    return _kde._kde_stack_gathered_grid(labels[safe], label_errs[safe], wt,
                                         grid, dx, sig_thresh)


def stack_batches(logwt, neighbors, model_labels, model_label_errs,
                  label_dict, label_grid, wt_thresh, cdf_thresh, batch_size,
                  dx=None, sig_thresh=5.0, device=None, dtype=None):
    """Stored per-object log-weights (Ndata, J) over their model indices
    `neighbors` -> normalized PDFs through the gathered KDE, batch by
    batch on `device` (labels in `dtype`, or as given).  Returns host
    arrays (pdfs, lmap, levid) and the label grid."""
    use_dict, ngrid, lab = _kde.pack_label_spec(
        label_dict, label_grid, model_labels, model_label_errs, dx=dx,
        sig_thresh=sig_thresh, device=device, dtype=dtype)
    grid = (np.asarray(label_dict.grid) if use_dict
            else np.asarray(label_grid))
    ndata = logwt.shape[0]
    pdfs = np.zeros((ndata, ngrid), np.float32)
    lmap = np.zeros(ndata, np.float32)
    levid = np.zeros(ndata, np.float32)
    for i0 in range(0, ndata, batch_size):
        sl = slice(i0, i0 + batch_size)
        lwt = torch.as_tensor(np.ascontiguousarray(logwt[sl]), device=device)
        idx = torch.as_tensor(np.asarray(neighbors[sl], np.int64),
                              device=device)
        lm, lv, wt = _gof_weights(lwt)
        wt = _kde.threshold_weights(wt, wt_thresh, cdf_thresh)
        pdf = _gathered_pdf(use_dict, lab, ngrid, idx, wt)
        pdfs[sl] = _kde.norm_rows(pdf).cpu().numpy()
        lmap[sl] = lm.cpu().numpy()
        levid[sl] = lv.cpu().numpy()
    return pdfs, lmap, levid, grid


# ----------------------------------------------------------------------
# search
# ----------------------------------------------------------------------

def _order_keys(d, cols):
    """int64 keys ordering the float32 entries of `d` by (value,
    `cols`): the value's order-preserving int32 image in the high half,
    the column in the low half."""
    bits = d.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    return (key << 32) | cols


def _topk_smallest(d, k):
    """(values, columns) of the k smallest entries of each row of the
    float32 block `d`, ascending, the lowest column first among equal
    values: `lax.top_k(-d, k)`'s selection and order.

    `torch.topk` picks the k+1 smallest; rows whose k-th and (k+1)-th
    values differ have a unique k-set, ordered here by (value, column).
    Rows with a tie across the k-th place are selected again by exact
    int64 (value, column) keys.
    """
    n = d.shape[1]
    kk = min(k + 1, n)
    vals, idx = torch.topk(d, kk, dim=1, largest=False, sorted=True)
    tied = vals[:, k - 1] == vals[:, k] if kk > k else None
    vals, idx = vals[:, :k], idx[:, :k]
    if tied is not None:
        rows = tied.nonzero()[:, 0]
        if rows.numel():
            cols = torch.arange(n, device=d.device)
            sel = torch.topk(_order_keys(d[rows], cols), k, dim=1,
                             largest=False, sorted=True)[0] & 0xFFFFFFFF
            idx = idx.index_copy(0, rows, sel)
            vals = d.gather(1, idx)
    order = torch.argsort(idx, dim=1)
    idx = idx.gather(1, order)
    order = torch.argsort(vals.gather(1, order), dim=1, stable=True)
    idx = idx.gather(1, order)
    return d.gather(1, idx), idx


def _distances(q, qsq, Y, Ysq, lp_norm):
    if lp_norm == 2:
        return Ysq[None, :] - 2.0 * _kde.fp32_matmul(q, Y.T) + qsq
    diff = (q[:, None, :] - Y[None, :, :]).abs()
    return (diff if lp_norm == 1 else diff ** lp_norm).sum(dim=-1)


def _search(q, feats, feats_sq, *, K, k, lp_norm, dbound):
    """Exact K-ensemble search and union (`_search_jit`, knn.py:146-216).

    ``q`` (B, Nf) float32 query features; ``feats`` (K, M, Nf) and
    ``feats_sq`` (K, M).  Returns (idx (B, K*k) int64 with -99 padding,
    valid (B, K*k) bool, nidx (B,)).
    """
    B = q.shape[0]
    M = feats.shape[1]
    qsq = (q * q).sum(dim=1, keepdim=True)
    bound = dbound ** lp_norm if np.isfinite(dbound) else float("inf")
    chunk = _topk_chunk_cols(B, k)
    idxs, oks = [], []
    for e in range(K):
        Y, Ysq = feats[e], feats_sq[e]
        if M > chunk and chunk >= k:
            # Per-chunk exact top-k, then an exact merge: the candidates
            # are concatenated in column order, so a position order among
            # equal values is the column order.
            cv, ci = [], []
            for lo in range(0, M, chunk):
                hi = min(M, lo + chunk)
                v, i = _topk_smallest(
                    _distances(q, qsq, Y[lo:hi], Ysq[lo:hi], lp_norm), k)
                cv.append(v)
                ci.append(i + lo)
            vals, sel = _topk_smallest(torch.cat(cv, dim=1), k)
            idx = torch.cat(ci, dim=1).gather(1, sel)
        else:
            vals, idx = _topk_smallest(_distances(q, qsq, Y, Ysq, lp_norm),
                                       k)
        idxs.append(idx)
        oks.append(vals <= bound)
    # (K, B, k) -> (B, K*k)
    idx = torch.stack(idxs, dim=1).reshape(B, K * k)
    ok = torch.stack(oks, dim=1).reshape(B, K * k)

    # First-seen-order unique (pandas.unique semantics), as in JAX:
    # out-of-bound slots become per-slot sentinels first, so they can
    # neither shadow an in-bound occurrence nor be marked duplicates.
    slot = torch.arange(K * k, device=q.device)[None, :]
    idx_d = torch.where(ok, idx, _BIG + slot)
    order = torch.argsort(idx_d, dim=1, stable=True)
    sorted_idx = idx_d.gather(1, order)
    dup_sorted = torch.cat(
        [torch.zeros((B, 1), dtype=torch.bool, device=q.device),
         sorted_idx[:, 1:] == sorted_idx[:, :-1]], dim=1)
    dup = torch.zeros_like(dup_sorted).scatter(1, order, dup_sorted)
    invalid = dup | ~ok
    perm = torch.argsort(torch.where(invalid, _BIG + slot, slot), dim=1,
                         stable=True)
    cidx = idx.gather(1, perm)
    cvalid = ~invalid.gather(1, perm)
    nidx = cvalid.sum(dim=1)
    return torch.where(cvalid, cidx, -99), cvalid, nidx


def _near_ties(q, feats, k, lp_norm=2, rtol=1e-5):
    """Where roundoff may decide a neighbour list: for each query row,
    whether some ensemble's k-th and (k+1)-th distances, or two adjacent
    distances inside its k, lie within `rtol` of each other, and the
    models in those near-equal pairs.

    Distances are recomputed in float64 from `q` (B, Nf) and `feats`
    (K, M, Nf).  The gap is relative to the scale at which float32
    rounds the distance: |q|^2 + |Y|^2 of the pair's terms for
    ``lp_norm=2``, the distance itself otherwise.  Returns (rows (B,)
    bool, cands (B, M) bool), on `q`'s device.
    """
    q = torch.as_tensor(q).to(torch.float64)
    feats = torch.as_tensor(feats).to(device=q.device, dtype=torch.float64)
    B, M = q.shape[0], feats.shape[1]
    kk = min(k + 1, M)
    rows = torch.zeros(B, dtype=torch.bool, device=q.device)
    cands = torch.zeros((B, M), dtype=torch.bool, device=q.device)
    qsq = (q * q).sum(dim=1, keepdim=True)
    for Y in feats:
        d = ((q[:, None, :] - Y[None]).abs() ** lp_norm).sum(dim=-1)
        vals, idx = torch.topk(d, kk, dim=1, largest=False, sorted=True)
        scale = (qsq + (Y * Y).sum(dim=1)[idx] if lp_norm == 2
                 else vals.abs())
        near = (vals[:, 1:] - vals[:, :-1]) <= rtol * scale[:, 1:]
        rows |= near.any(dim=1)
        pair = torch.zeros_like(vals, dtype=torch.bool)
        pair[:, 1:] |= near
        pair[:, :-1] |= near
        cands.scatter_(1, idx, pair | cands.gather(1, idx))
    return rows, cands


# ----------------------------------------------------------------------
# feature maps
# ----------------------------------------------------------------------

def _resolve_feature_map(feature_map, fmap_args, fmap_kwargs):
    if feature_map == "identity":
        def feature_map(x, xe, *a, **k):
            return x, xe
    elif feature_map == "magnitude":
        feature_map = _tf.magnitude
    elif feature_map == "luptitude":
        feature_map = _tf.luptitude
    elif not callable(feature_map):
        raise ValueError("The provided feature map is not valid.")
    return lambda x, xe: feature_map(x, xe, *fmap_args, **fmap_kwargs)


# ----------------------------------------------------------------------
# the fitter
# ----------------------------------------------------------------------

def _pad_rows(x, rows):
    """Host rows padded with zeros up to `rows` (`bruteforce._pad_rows`
    of the JAX package: zero errors mark the pad rows' bands bad)."""
    pad = rows - x.shape[0]
    if pad <= 0:
        return x
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])


class NearestNeighbors:
    """KMCkNN fitter over a fixed model set (knn.py:40-156).

    `K` Monte-Carlo ensembles (default 25), `feature_map` in
    {'identity', 'magnitude', 'luptitude'} or a callable ``(x, xe) ->
    (features, errors)`` on tensors, `leafsize` accepted and ignored (no
    trees).  The model set stays on `device` in its dtype (float64 stays
    float64); the features are float32 (K, M, Nf) with their squared
    norms.  ``device="cuda"`` without a card raises: nothing falls back
    to the CPU.
    """

    def __init__(self, models, models_err, models_mask, leafsize=50, K=25,
                 feature_map="luptitude", fmap_args=None, fmap_kwargs=None,
                 rng=None, seed=None, verbose=True, device="cuda"):
        del leafsize  # KDTree tuning knob; no trees here
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("NearestNeighbors(device='cuda') needs a "
                               "CUDA device; none is available")
        self.models = self._tensor(models)
        self.models_err = self._tensor(models_err, self.models.dtype)
        self.models_mask = self._tensor(models_mask, self.models.dtype)
        self._dtype = self.models.dtype
        self.NMODEL, self.NDIM = self.models.shape
        self.K = int(K)
        self.fmap_args = fmap_args or ()
        self.fmap_kwargs = fmap_kwargs or {}
        self.fmap_spec = (feature_map, tuple(self.fmap_args),
                          tuple(sorted(self.fmap_kwargs.items())))
        self.feature_map = _resolve_feature_map(feature_map, self.fmap_args,
                                                self.fmap_kwargs)
        self.rng = rng if rng is not None else np.random.default_rng(seed)

        self.NDATA = None
        self.neighbors = None
        self.Nneighbors = None
        self.k = None
        self.fit_lnprior = None
        self.fit_lnlike = None
        self.fit_lnprob = None
        self.fit_Ndim = None
        self.fit_chi2 = None
        self.fit_scale = None
        self.fit_scale_err = None
        self._fit_rows_done = 0

        # K Monte-Carlo feature ensembles (knn.py:158-188): the jitters
        # are drawn on the host from the original arrays (the JAX
        # constructor's draw), then mapped to feature space on the card
        # one ensemble at a time, as `jax.vmap` maps them.
        mods = np.asarray(models, dtype=float)
        errs = np.asarray(models_err, dtype=float)
        jits = self.rng.normal(mods[None], errs[None],
                               (self.K,) + mods.shape).astype(np.float32)
        jits = torch.tensor(jits, device=self.device)
        self.features = torch.stack([
            self.feature_map(j, self.models_err)[0].to(torch.float32)
            for j in jits]).contiguous()
        self.features_sqnorm = (self.features ** 2).sum(dim=-1)
        if verbose:
            import sys
            sys.stderr.write("{0}/{0} MC feature ensembles constructed\n"
                             .format(self.K))

    def _tensor(self, x, dtype=None):
        """`x` on the fitter's device (host arrays copied)."""
        return _kde._as(x, self.device, dtype)

    # ------------------------------------------------------------------

    def _search_fn(self, k, lp_norm, dbound):
        """(B, Nf) float32 query features -> (idx, valid, nidx) over the
        K ensembles (see `_search`)."""
        def search(q):
            return _search(self._tensor(q, torch.float32), self.features,
                           self.features_sqnorm, K=self.K, k=k,
                           lp_norm=lp_norm, dbound=float(dbound))
        return search

    def _query_features(self, jq, de):
        """Float32 features of the jittered queries `jq` (host, B x Nf)
        with errors `de` (knn.py:358-361)."""
        q, _ = self.feature_map(self._tensor(jq, torch.float32),
                                self._tensor(de, torch.float32))
        return q.to(torch.float32)

    def _replica(self, device):
        """The fitter's device tensors on `device`: (features, their
        squared norms, models, errors, mask)."""
        return tuple(t.to(device) for t in (
            self.features, self.features_sqnorm, self.models,
            self.models_err, self.models_mask))

    def _fit_batch(self, jq, d, de, dm, k, lp_norm, dbound, lprob_spec,
                   rep=None):
        """One batch's search, union and exact posterior
        (`_knn_fit_batch_jit`): (idx, valid, nidx, res) on the device of
        `rep` (a `_replica`; the fitter's own tensors by default)."""
        feats, feats_sq, m, me, mm = rep or self._replica(self.device)
        q = self._query_features(jq, de).to(feats.device)
        idx, valid, nidx = _search(q, feats, feats_sq, K=self.K, k=k,
                                   lp_norm=lp_norm, dbound=dbound)
        x, xe, xm = (_kde._as(a, feats.device, self._dtype)
                     for a in (d, de, dm))
        res = _gathered_lprob(x, xe, xm, idx, valid, m, me, mm,
                              lprob_spec=lprob_spec)
        return idx, valid, nidx, res

    def _alloc_fits(self, ndata, k, track_scale):
        j = self.K * k
        inf = np.inf
        self.NDATA = ndata
        self.k = k
        self.Nneighbors = np.zeros(ndata, np.int32)
        self.neighbors = np.full((ndata, j), -99, np.int32)
        self.fit_lnprior = np.full((ndata, j), -inf, np.float32)
        self.fit_lnlike = np.full((ndata, j), -inf, np.float32)
        self.fit_lnprob = np.full((ndata, j), -inf, np.float32)
        self.fit_Ndim = np.zeros((ndata, j), np.int32)
        self.fit_chi2 = np.full((ndata, j), inf, np.float32)
        if track_scale:
            self.fit_scale = np.ones((ndata, j), np.float32)
            self.fit_scale_err = np.zeros((ndata, j), np.float32)
        else:
            self.fit_scale = None
            self.fit_scale_err = None

    def _store(self, i0, n, idx, nidx, res):
        sl = slice(i0, i0 + n)

        def host(t, dt=np.float32):
            return t[:n].cpu().numpy().astype(dt)

        self.neighbors[sl] = host(idx, np.int32)
        self.Nneighbors[sl] = host(nidx, np.int32)
        lnprior, lnlike, lnprob, ndim, chi2, scale, scale_err = res
        self.fit_lnprior[sl] = host(lnprior)
        self.fit_lnlike[sl] = host(lnlike)
        self.fit_lnprob[sl] = host(lnprob)
        self.fit_Ndim[sl] = host(ndim, np.int32)
        self.fit_chi2[sl] = host(chi2)
        if scale is not None and self.fit_scale is not None:
            self.fit_scale[sl] = host(scale)
            self.fit_scale_err[sl] = host(scale_err)

    def _data_batches(self, data, data_err, data_mask, batch_size, rng,
                      verbose, label):
        """Yield (i0, n, jittered query, padded data triplet) host batches.

        Each batch is padded with zero rows before its query jitter
        ``rng.normal(d, |de|)`` is drawn (knn.py:358-361): the pad rows'
        zero-scale draws consume the stream as in the JAX module.
        """
        ndata = data.shape[0]
        for i0, n in progress_iter(
                ((i, min(batch_size, ndata - i))
                 for i in range(0, ndata, batch_size)),
                total=ndata, label=label, verbose=verbose, sizes=True):
            d = _pad_rows(data[i0:i0 + n], batch_size)
            de = _pad_rows(data_err[i0:i0 + n], batch_size)
            dm = _pad_rows(data_mask[i0:i0 + n], batch_size)
            jq = rng.normal(d, np.abs(de))
            yield i0, n, jq, d, de, dm

    @staticmethod
    def _host_data(data, data_err, data_mask):
        return tuple(np.atleast_2d(np.asarray(a, float))
                     for a in (data, data_err, data_mask))

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def fit(self, data, data_err, data_mask, lprob_func=None, rng=None,
            k=20, eps=1e-3, lp_norm=2, distance_upper_bound=np.inf,
            lprob_args=None, lprob_kwargs=None, track_scale=False,
            verbose=True, batch_size=4096, approx=False,
            checkpoint_every=None, checkpoint_file=None, resume=False):
        """KMCkNN fit: neighbour union + exact posteriors on the union
        (knn.py:190-388).  Stores `neighbors` / `Nneighbors` and the
        (Ndata, K*k) padded fit grids on the host.

        ``checkpoint_every=N`` saves the fit prefix every N batches;
        ``resume=True`` (with the same seeded `rng`) continues from the
        checkpoint bit for bit: skipped batches still draw their query
        jitter, so the remaining draws line up.
        """
        del eps, approx  # exact search
        data, data_err, data_mask = self._host_data(data, data_err,
                                                    data_mask)
        rng = rng or self.rng
        ndata = data.shape[0]
        batch_size = min(batch_size, max(256, ndata))
        done = resume_fit_rows(self, resume, checkpoint_file, ndata,
                               checkpoint_every)
        if not done:
            self._alloc_fits(ndata, k, track_scale)
        self._fit_rows_done = done
        lprob_spec = _like.static_spec(lprob_func, lprob_args, lprob_kwargs)
        nb = 0
        for i0, n, jq, d, de, dm in self._data_batches(
                data, data_err, data_mask, batch_size, rng, verbose,
                "Fitting object"):
            if i0 + n <= done:
                continue  # its jitter is drawn: the stream stays aligned
            idx, _, nidx, res = self._fit_batch(
                jq, d, de, dm, k, lp_norm, float(distance_upper_bound),
                lprob_spec)
            self._store(i0, n, idx, nidx, res)
            self._fit_rows_done = i0 + n
            nb += 1
            if checkpoint_every and nb % checkpoint_every == 0:
                _ckpt.save(checkpoint_file, self)
        return self

    def predict(self, model_labels, model_label_errs, label_dict=None,
                label_grid=None, logwt=None, kde_args=None, kde_kwargs=None,
                return_gof=False, verbose=True, batch_size=1024,
                wt_thresh=1e-3, cdf_thresh=2e-4):
        """PDFs from stored neighbour fits (knn.py:390-558)."""
        del verbose
        if logwt is None:
            logwt = self.fit_lnprob
        if logwt is None:
            raise ValueError("Fits have not been computed and weights have "
                             "not been provided.")
        if label_dict is None and label_grid is None:
            raise ValueError("`label_dict` or `label_grid` must be "
                             "specified.")
        dx, sig_thresh, wt_thresh, cdf_thresh = _kde.resolve_kde_opts(
            kde_args, kde_kwargs, wt_thresh, cdf_thresh)
        pdfs, lmap, levid, _ = stack_batches(
            np.asarray(logwt, np.float32), self.neighbors, model_labels,
            model_label_errs, label_dict, label_grid, wt_thresh, cdf_thresh,
            batch_size, dx=dx, sig_thresh=sig_thresh, device=self.device,
            dtype=self._dtype)
        if return_gof:
            return pdfs, (lmap, levid)
        return pdfs

    def fit_predict(self, data, data_err, data_mask, model_labels,
                    model_label_errs, lprob_func=None, label_dict=None,
                    label_grid=None, kde_args=None, kde_kwargs=None,
                    lprob_args=None, lprob_kwargs=None, return_gof=False,
                    track_scale=False, verbose=True, save_fits=False,
                    rng=None, k=20, eps=1e-3, lp_norm=2,
                    distance_upper_bound=np.inf, batch_size=4096,
                    wt_thresh=1e-3, cdf_thresh=2e-4, approx=False,
                    mesh=None, _post_setup=None):
        """Fit + PDF prediction per batch on the device (knn.py:560-874):
        jittered query features -> ensemble search -> union posterior ->
        thresholded gathered KDE; only (pdf, lmap, levid) come back, and
        the fit grids too with ``save_fits=True``.

        With `mesh` (a `parallel.Mesh`; not with `save_fits`) the batch
        size rounds up to a multiple of ``mesh.size``, each padded batch
        draws its query jitter on the host exactly as one device's call
        does, and splits into one row block a shard, each run on its
        device with the ensembles, models and labels copied there; a
        one-shard mesh gives the single-device result bit for bit."""
        del eps, approx  # exact search
        if mesh is not None:
            _mesh.check_mesh(mesh)
            if save_fits:
                raise ValueError("mesh-sharded fit_predict streams PDFs "
                                 "only; save_fits is unsupported")
        data, data_err, data_mask = self._host_data(data, data_err,
                                                    data_mask)
        rng = rng or self.rng
        ndata = data.shape[0]
        batch_size = min(batch_size, max(256, ndata))
        devices = (self.device,) if mesh is None else mesh.devices
        batch_size = -(-batch_size // len(devices)) * len(devices)
        per = batch_size // len(devices)
        dx, sig_thresh, wt_thresh, cdf_thresh = _kde.resolve_kde_opts(
            kde_args, kde_kwargs, wt_thresh, cdf_thresh)
        if save_fits:
            self._alloc_fits(ndata, k, track_scale)
        lprob_spec = _like.static_spec(lprob_func, lprob_args, lprob_kwargs)
        use_dict, ngrid, lab = _kde.pack_label_spec(
            label_dict, label_grid, model_labels, model_label_errs,
            dx=dx, sig_thresh=sig_thresh, device=self.device,
            dtype=self._dtype)
        post, out_width = ((None, ngrid) if _post_setup is None
                           else _post_setup(ndata, batch_size))
        pdfs = np.zeros((ndata, out_width), np.float32)
        lmap = np.zeros(ndata, np.float32)
        levid = np.zeros(ndata, np.float32)

        # Telemetry: ensemble-search distance pairs, exact chi^2 evals on
        # the padded neighbour unions, PDF stacks.
        _metrics.count("knn_search_pairs", ndata * self.K * self.NMODEL)
        _metrics.count("chi2_pair_evals", ndata * self.K * k)
        _metrics.count("pdf_stacks", ndata)
        reps = _mesh.per_device(devices, lambda dev: (
            self._replica(dev), _mesh.to_device(lab, dev)))

        def shard(jq, d, de, dm, rep, lab):
            idx, _, nidx, res = self._fit_batch(
                jq, d, de, dm, k, lp_norm, float(distance_upper_bound),
                lprob_spec, rep)
            lm, lv, wt = _gof_weights(res[2])
            # The union is compacted to the front: the KDE runs on the
            # columns up to the shard's widest union (rounded up to 128);
            # the columns past it carry zero weight.
            w = min(idx.shape[1], -(-max(int(nidx.max()), 1) // 128) * 128)
            wt = _kde.threshold_weights(wt[:, :w], wt_thresh, cdf_thresh)
            pdf = _kde.norm_rows(_gathered_pdf(use_dict, lab, ngrid,
                                               idx[:, :w], wt))
            return pdf, lm, lv, idx, nidx, res

        with _metrics.timer("knn.fit_predict"):
            for i0, n, *batch in self._data_batches(
                    data, data_err, data_mask, batch_size, rng, verbose,
                    "Fitting object"):
                outs = [shard(*(a[r * per:(r + 1) * per] for a in batch),
                              *rep) for r, rep in enumerate(reps)]
                for r, (pdf, lm, lv, idx, nidx, res) in enumerate(outs):
                    j0 = i0 + r * per
                    m = min(per, i0 + n - j0)
                    if m <= 0:
                        continue
                    if post is not None:
                        pdf = post(pdf, j0)
                    sl = slice(j0, j0 + m)
                    pdfs[sl] = pdf[:m].cpu().numpy()
                    lmap[sl] = lm[:m].cpu().numpy()
                    levid[sl] = lv[:m].cpu().numpy()
                    if save_fits:
                        self._store(j0, m, idx, nidx, res)
        if return_gof:
            return pdfs, (lmap, levid)
        return pdfs

    def fit_summarize(self, data, data_err, data_mask, model_labels,
                      model_label_errs, lprob_func=None, label_dict=None,
                      label_grid=None, kde_args=None, kde_kwargs=None,
                      lprob_args=None, lprob_kwargs=None, verbose=True,
                      rng=None, k=20, eps=1e-3, lp_norm=2,
                      distance_upper_bound=np.inf, batch_size=4096,
                      wt_thresh=1e-3, cdf_thresh=2e-4, approx=False,
                      mesh=None, pkern="lorentz", pkern_grid=None,
                      summary_seed=0):
        """`fit_predict` + `pdfs_summarize` on the device per batch: only
        the 21 summary columns per object come back (the MC uniforms of
        `BruteForce.fit_summarize`).  Returns
        ``(PDFSummary, (lmap, levid))``."""
        grid = _summ.label_grid_of(label_dict, label_grid)
        cols, gof = self.fit_predict(
            data, data_err, data_mask, model_labels, model_label_errs,
            lprob_func=lprob_func, label_dict=label_dict,
            label_grid=label_grid, kde_args=kde_args,
            kde_kwargs=kde_kwargs, lprob_args=lprob_args,
            lprob_kwargs=lprob_kwargs, return_gof=True, verbose=verbose,
            rng=rng, k=k, eps=eps, lp_norm=lp_norm,
            distance_upper_bound=distance_upper_bound,
            batch_size=batch_size, wt_thresh=wt_thresh,
            cdf_thresh=cdf_thresh, approx=approx, mesh=mesh,
            _post_setup=_summ.stream_summary_setup(
                grid, pkern, pkern_grid, summary_seed, device=self.device))
        return _summ.unpack_summary(cols), gof
