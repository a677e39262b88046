"""
Manifold fitters: the shared `_Network` machinery, SelfOrganizingMap and
GrowingNeuralGas.

Port of `frankenz_tpu.models.networks` (reference `frankenz/networks.py`:
`_Network` :121, learning / neighbourhood functions :38-118,
`SelfOrganizingMap` :1490, `GrowingNeuralGas` :1870).  A network
compresses a large model set onto Nnode << Nmodel nodes: models are soft-assigned to nodes
(`populate_network`), each node carries a label PDF of its members, and
new data are fit against the nodes first, either stopping there
(``nodes_only=True``, the cell-conditioned photo-z mode) or refining with
exact posteriors on the union of the selected nodes' member models.

The batch programs of the JAX module (`_populate_batch_jit`,
`_gather_union_jit`, `_union_fp_jit`, ...) are plain functions on
tensors here, on the network's device; member tables live on the host
with the JAX module's padding (index -99, log-weight -inf).  Training
runs, on eligible configurations, as one launch of the hand-written
kernel `kernels.som.som_train` (K8; its plain version on CPU tensors),
else as a plain step loop over the port's `logprob` (the counterpart of
`_som_train_jit`).  GrowingNeuralGas training likewise runs as one
launch of `kernels.gng.gng_train` (K9) or as a step loop, the
counterpart of `_gng_train_jit`.

Both training runs and `_Network.fit` checkpoint and resume
(``checkpoint_every`` / ``resume``, `utils.checkpoint`): the training in
segments, one kernel launch a segment on the kernel routes, bit for bit
one uninterrupted call.  ``fit_predict(save_fits=False, mesh=)`` splits
each batch over the devices of a `parallel.Mesh`.  The JAX argument
``use_pallas`` is ``use_kernel`` here, with the same three-way meaning.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..kernels import gng as _gng
from ..kernels import som as _som
from ..ops import kde as _kde
from ..ops import likelihood as _like
from ..ops import summarize as _summ
from ..parallel import mesh as _mesh
from ..utils import checkpoint as _ckpt
from ..utils.progress import progress_iter, train_note
from . import knn as _knn
from .bruteforce import _batch_slices, resume_fit_rows

__all__ = ["SelfOrganizingMap", "GrowingNeuralGas", "_Network", "learn_linear",
           "learn_geometric", "learn_harmonic", "neighbor_gauss",
           "neighbor_lorentz", "som_kernel_draws"]


# ----------------------------------------------------------------------
# Learning-rate schedules and neighbourhood kernels (networks.py:38-118)
# ----------------------------------------------------------------------

def learn_linear(t, start=0.5, end=0.1, **kwargs):
    """Linear interpolation from `start` to `end` over t in [0, 1]."""
    return (1.0 - t) * start + t * end


def learn_geometric(t, start=0.5, end=0.1, **kwargs):
    """Geometric (log-linear) interpolation from `start` to `end`."""
    return torch.exp((1.0 - torch.as_tensor(t)) * math.log(start)
                     + t * math.log(end))


def learn_harmonic(t, start=0.5, end=0.1, **kwargs):
    """Weighted harmonic mean of `start` and `end`."""
    return 1.0 / ((1.0 - t) / start + t / end)


# Phase-1 membership slab width of populate_network (networks.py:89-92):
# models matching more nodes re-run once at an escalated cap.
_POPULATE_PHASE1_CAP = 16

_LEARN = {"linear": learn_linear, "geometric": learn_geometric,
          "harmonic": learn_harmonic}
_LEARN_NAMES = {learn_linear: "linear", learn_geometric: "geometric",
                learn_harmonic: "harmonic"}


def neighbor_gauss(t, pos, positions, nside, start=0.7, end=0.02,
                   rate="harmonic", **kwargs):
    """Gaussian lattice neighbourhood with annealed width sigma(t)*nside."""
    learn = _LEARN[rate] if isinstance(rate, str) else rate
    if nside is None:
        nside = math.sqrt(len(positions))
    sqdist = ((pos - positions) ** 2).sum(dim=1)
    sigma = learn(t, start=start, end=end) * nside
    return torch.exp(-0.5 * sqdist / sigma ** 2), sigma


def neighbor_lorentz(t, pos, positions, nside, start=0.7, end=0.02,
                     rate="harmonic", **kwargs):
    """Lorentzian lattice neighbourhood with annealed width."""
    learn = _LEARN[rate] if isinstance(rate, str) else rate
    sqdist = ((pos - positions) ** 2).sum(dim=1)
    sigma = learn(t, start=start, end=end) * nside
    return sigma ** 2 / (sqdist + sigma ** 2), sigma


# ----------------------------------------------------------------------
# Batch programs (networks.py:118-360), as functions on tensors
# ----------------------------------------------------------------------

_DEFAULT_LPNET_KWARGS = {"free_scale": True, "ignore_model_err": True,
                         "return_scale": True}


def _lpnet(x, xe, xm, nodes, lpnet_spec):
    """Node log-posteriors of a data batch (nodes error-free, unmasked)."""
    func, args, kw_items = lpnet_spec
    func = func or _like.logprob
    return func(x, xe, xm, nodes, torch.zeros_like(nodes),
                torch.ones_like(nodes), *args, **dict(kw_items))


def _threshold_sel(lnprob, wt_thresh, cdf_thresh):
    """Boolean selection over the last axis (networks.py:323-332)."""
    if wt_thresh is None and cdf_thresh is None:
        return torch.ones(lnprob.shape, dtype=torch.bool,
                          device=lnprob.device)
    if wt_thresh is not None:
        cut = math.log(wt_thresh) + lnprob.amax(dim=-1, keepdim=True)
        return lnprob > cut
    prob = torch.exp(lnprob - torch.logsumexp(lnprob, dim=-1, keepdim=True))
    sorted_p, order = torch.sort(prob, dim=-1, stable=True)
    keep_sorted = torch.cumsum(sorted_p, dim=-1) <= (1.0 - cdf_thresh)
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def _top_k(x, k):
    """`jax.lax.top_k` along the last axis: descending, ties to the lower
    index (a stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _node_fit(x, xe, xm, nodes_occ, *, lpnet_spec, wt_thresh, cdf_thresh):
    """Node fit of a batch and its threshold mask (`_node_fit_jit`)."""
    res = _lpnet(x, xe, xm, nodes_occ, lpnet_spec)
    return res, _threshold_sel(res[2], wt_thresh, cdf_thresh)


def _populate_batch(x, xe, xm, nodes, *, lpnet_spec, wt_thresh, cdf_thresh,
                    cap, track_scale):
    """One populate batch (`_populate_batch_jit`): node log-posteriors,
    BMU, thresholded top-`cap` memberships.  `torch.topk` may order tied
    entries unlike `jax.lax.top_k`, but only the first `cnt` (finite,
    selected) slots are read, and that set is the same."""
    res = _lpnet(x, xe, xm, nodes, lpnet_spec)
    lnp = res[2]
    bmu = lnp.argmax(dim=1)
    sel = _threshold_sel(lnp, wt_thresh, cdf_thresh)
    cnt = sel.sum(dim=1)
    masked = torch.where(sel, lnp, -torch.inf)
    lmap = masked.amax(dim=1)
    levid = torch.logsumexp(masked, dim=1)
    top_lw, top_node = torch.topk(masked, cap, dim=1)
    top_lw = top_lw - levid[:, None]
    if track_scale and len(res) > 5 and res[5] is not None:
        top_scale = res[5].gather(1, top_node)
        top_serr = res[6].gather(1, top_node)
    else:
        top_scale = torch.ones_like(top_lw)
        top_serr = torch.zeros_like(top_lw)
    return cnt, top_lw, top_node, top_scale, top_serr, bmu, lmap, levid


def _node_pdf_weights(lwt):
    """(lmap, levid, wt) of padded member log-weight rows (-inf pads)."""
    lmap = lwt.amax(dim=1)
    levid = torch.logsumexp(lwt, dim=1)
    wt = torch.exp(lwt - levid[:, None])
    return lmap, levid, torch.where(torch.isfinite(lwt), wt, 0.0)


def _density_scale(pdf, levid):
    """Normalize PDF rows, then scale by exp(levid) (networks.py:495-496)."""
    return _kde.norm_rows(pdf) * torch.exp(levid)[:, None]


def _gather_union(x, xe, xm, nodes_occ, members, *, lpnet_spec, wt_thresh,
                  cdf_thresh, cap_sel, max_neighbors):
    """Exact-union neighbours (`_gather_union_jit`): node fit -> strongest
    `cap_sel` selected nodes -> the union of their members, deduplicated
    with a stable sort (invalid slots sorted last by the 1 << 30 key) and
    compacted in ascending model order to `max_neighbors` slots (-99
    pads).  Returns (idx (B, max_neighbors), nuniq (B,))."""
    res, sel = _node_fit(x, xe, xm, nodes_occ, lpnet_spec=lpnet_spec,
                         wt_thresh=wt_thresh, cdf_thresh=cdf_thresh)
    lnp = torch.where(sel, res[2], -torch.inf)
    top_lnp, top_nodes = _top_k(lnp, cap_sel)
    node_ok = torch.isfinite(top_lnp)
    nobj = x.shape[0]
    cand = members[top_nodes]  # (B, cap_sel, maxm)
    cand = torch.where(node_ok[:, :, None], cand, -99).reshape(nobj, -1)
    big = 1 << 30
    order = torch.sort(torch.where(cand < 0, big, cand), dim=1,
                       stable=True).indices
    sorted_c = cand.gather(1, order)
    dup = torch.zeros_like(sorted_c, dtype=torch.bool)
    dup[:, 1:] = (sorted_c[:, 1:] == sorted_c[:, :-1]) & (sorted_c[:, 1:] >= 0)
    uniq = torch.where(dup | (sorted_c < 0), -99, sorted_c)
    nuniq = (uniq >= 0).sum(dim=1)
    width = uniq.shape[1]
    key = (torch.where(uniq < 0, big, 0)
           + torch.arange(width, device=uniq.device)[None, :])
    compact = uniq.gather(1, torch.sort(key, dim=1, stable=True).indices)
    if width < max_neighbors:  # fewer candidates than slots
        compact = torch.cat([compact, torch.full(
            (nobj, max_neighbors - width), -99, dtype=compact.dtype,
            device=compact.device)], dim=1)
    return compact[:, :max_neighbors], nuniq


def _stack_node_pdfs(lwt, node_pdfs_occ):
    """nodes_only prediction: thresholded node weights @ node PDFs
    (networks.py:1113-1115), normalized per object."""
    lmap = lwt.amax(dim=1)
    levid = torch.logsumexp(lwt, dim=1)
    wt = torch.exp(lwt - levid[:, None])
    dt = torch.promote_types(wt.dtype, node_pdfs_occ.dtype)
    pdf = _kde.fp32_matmul(wt.to(dt), node_pdfs_occ.to(dt))
    return _kde.norm_rows(pdf), lmap, levid


def _nodes_only_fp(x, xe, xm, nodes_occ, node_pdfs_occ, *, lpnet_spec,
                   wt_thresh, cdf_thresh):
    """nodes_only fit_predict batch (`_nodes_only_fp_jit`): node fit ->
    thresholded node weights -> node-PDF stack."""
    res, sel = _node_fit(x, xe, xm, nodes_occ, lpnet_spec=lpnet_spec,
                         wt_thresh=wt_thresh, cdf_thresh=cdf_thresh)
    return _stack_node_pdfs(torch.where(sel, res[2], -torch.inf),
                            node_pdfs_occ)


def _union_fp(x, xe, xm, nodes_occ, members, models, models_err,
              models_mask, lab, *, lpnet_spec, lprob_spec, wt_thresh,
              cdf_thresh, cap_sel, max_neighbors, kde_wt_thresh,
              kde_cdf_thresh, use_dict, ngrid):
    """Exact-union fit_predict batch (`_union_fp_jit`): node fit ->
    member union -> exact posterior -> thresholded gathered KDE.  The
    KDE runs on the columns up to the widest union, rounded up to 128
    (the slots past it have weight 0).  Returns (pdf, lmap, levid,
    nuniq)."""
    idx, nuniq = _gather_union(x, xe, xm, nodes_occ, members,
                               lpnet_spec=lpnet_spec, wt_thresh=wt_thresh,
                               cdf_thresh=cdf_thresh, cap_sel=cap_sel,
                               max_neighbors=max_neighbors)
    res = _knn._gathered_lprob(x, xe, xm, idx, idx >= 0, models, models_err,
                               models_mask, lprob_spec=lprob_spec)
    lmap, levid, wt = _knn._gof_weights(res[2])
    w = min(max_neighbors, -(-max(int(nuniq.max()), 1) // 128) * 128)
    wt = _kde.threshold_weights(wt[:, :w], kde_wt_thresh, kde_cdf_thresh)
    pdf = _knn._gathered_pdf(use_dict, lab, ngrid, idx[:, :w], wt)
    return _kde.norm_rows(pdf), lmap, levid, nuniq


def _pad_rows(t, rows):
    """`t` with zero rows appended up to `rows` (the JAX batches' padding:
    zero errors mark the pad rows' bands bad)."""
    pad = rows - t.shape[0]
    if pad <= 0:
        return t
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


def _union_error(nu, max_neighbors):
    return ValueError("neighbor union ({}) exceeds max_neighbors ({}); raise "
                      "`max_neighbors` or tighten `wt_thresh`".format(
                          int(nu.max()), max_neighbors))


class _Network:
    """Shared node-network machinery (reference `_Network`,
    networks.py:121).

    Subclasses set `self.nodes` (Nnode, Nfilt) and `self.nodes_pos`
    (Nnode, Nproj), host arrays, in `train_network`; everything else
    lives here.  The model set is kept on `device` in its dtype (float64
    stays float64, float32 stays float32); data, nodes and labels are
    converted to that dtype for the fits.  ``device="cuda"`` without a
    card raises: nothing falls back to the CPU.
    """

    def __init__(self, models, models_err, models_mask, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("{}(device='cuda') needs a CUDA device; none "
                               "is available".format(type(self).__name__))
        self.models = self._tensor(models)
        self.models_err = self._tensor(models_err, self.models.dtype)
        self.models_mask = self._tensor(models_mask, self.models.dtype)
        self._dtype = self.models.dtype
        self._models_np = np.asarray(models, dtype=float)
        self._models_err_np = np.asarray(models_err, dtype=float)
        self._models_mask_np = np.asarray(models_mask, dtype=float)
        self.NMODEL, self.NDIM = self.models.shape
        self.models_lmap = np.full(self.NMODEL, -np.inf)
        self.models_levid = np.full(self.NMODEL, -np.inf)

        self.nodes = None
        self.nodes_pos = None
        self.NNODE = None
        self.NPROJ = None

        # Padded membership tables (built by populate_network).
        self.nodes_idxs = None        # (Nnode, maxm) int32, -99 pad
        self.nodes_logwts = None      # (Nnode, maxm) float32, -inf pad
        self.nodes_scales = None      # (Nnode, maxm) float32, 1 pad
        self.nodes_scales_err = None  # (Nnode, maxm) float32, 0 pad
        self.nodes_bmus = None        # (Nnode, maxb) int32, -99 pad
        self.nodes_Nmatch = None      # (Nnode,) int32
        self.nodes_Nbmu = None        # (Nnode,) int32
        self.nodes_only = None

        # Fit state (dense / padded, see fit()).
        self.NDATA = None
        self.neighbors = None
        self.Nneighbors = None
        self.fit_lnprior = None
        self.fit_lnlike = None
        self.fit_lnprob = None
        self.fit_Ndim = None
        self.fit_chi2 = None
        self.fit_scale = None
        self.fit_scale_err = None
        self._fit_rows_done = 0

        self.lpnet_func = None
        self.lpnet_args = ()
        self.lpnet_kwargs = None

    def _tensor(self, x, dtype=None):
        """`x` on the network's device; host arrays are copied (they may
        be read-only views)."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _data(self, data, data_err, data_mask):
        """The catalog as (host float arrays, device tensors in the
        network's dtype)."""
        host = tuple(np.atleast_2d(np.asarray(a, float))
                     for a in (data, data_err, data_mask))
        return host, tuple(self._tensor(a, self._dtype) for a in host)

    def _lpnet_spec(self):
        return _like.static_spec(self.lpnet_func or _like.logprob,
                                 self.lpnet_args or (),
                                 self.lpnet_kwargs or _DEFAULT_LPNET_KWARGS)

    def _nodes_tensor(self):
        return self._tensor(np.asarray(self.nodes), self._dtype)

    # ------------------------------------------------------------------
    # populate
    # ------------------------------------------------------------------

    def populate_network(self, lpnet_func=None, wt_thresh=1e-3,
                         cdf_thresh=2e-4, lpnet_args=None,
                         lpnet_kwargs=None, track_scale=True, verbose=True,
                         batch_size=8192, max_nodes_per_model=64):
        """Soft-assign every model to its matching nodes (networks.py:
        175-356): per model batch the (B, Nnode) node log-posteriors
        (default free-scale, error-free), BMU by argmax, thresholded
        memberships, per-model normalized log-weights and scales, into
        the padded member tables.  Two-phase cap: a 16-slot slab first;
        models matching more nodes run again at the next power of two
        that holds them all, and a model matching more than
        `max_nodes_per_model` nodes raises."""
        if lpnet_func is None:
            lpnet_func = _like.logprob
        lpnet_args = lpnet_args or ()
        if lpnet_kwargs is None:
            lpnet_kwargs = dict(_DEFAULT_LPNET_KWARGS)
        self.lpnet_func = lpnet_func
        self.lpnet_args = lpnet_args
        self.lpnet_kwargs = lpnet_kwargs

        nodes = self._nodes_tensor()
        nnode = nodes.shape[0]
        cap = min(int(max_nodes_per_model), nnode)
        cap1 = min(_POPULATE_PHASE1_CAP, cap)
        lpnet_spec = _like.static_spec(lpnet_func, lpnet_args, lpnet_kwargs)

        def dispatch(rows, bcap):
            x, xe, xm = (_pad_rows(t[rows], batch_size) for t in (
                self.models, self.models_err, self.models_mask))
            out = _populate_batch(x, xe, xm, nodes, lpnet_spec=lpnet_spec,
                                  wt_thresh=wt_thresh, cdf_thresh=cdf_thresh,
                                  cap=bcap, track_scale=bool(track_scale))
            return [t.cpu().numpy() for t in out]

        rows_l, cols, lws, scs, ses = [], [], [], [], []
        bmus = np.zeros(self.NMODEL, np.int64)

        def collect(model_idx, cnt, top_lw, top_node, top_scale, top_serr):
            bcap = top_lw.shape[1]
            r, c = np.nonzero(np.arange(bcap)[None, :] < cnt[:, None])
            rows_l.append(model_idx[r])
            cols.append(top_node[r, c])
            lws.append(top_lw[r, c])
            scs.append(top_scale[r, c])
            ses.append(top_serr[r, c])

        tail_idx = []
        tail_max = 0
        for i0, n in progress_iter(_batch_slices(self.NMODEL, batch_size),
                                   total=self.NMODEL, label="Mapping models",
                                   verbose=verbose, sizes=True):
            cnt, top_lw, top_node, top_scale, top_serr, bmu, lmap, levid = \
                dispatch(slice(i0, i0 + n), cap1)
            cnt = cnt[:n]
            over = cnt > cap1
            if over.any():
                tail_idx.append(np.flatnonzero(over) + i0)
                tail_max = max(tail_max, int(cnt.max()))
                cnt = np.where(over, 0, cnt)  # re-collected in phase 2
            collect(np.arange(i0, i0 + n), cnt, top_lw[:n], top_node[:n],
                    top_scale[:n], top_serr[:n])
            bmus[i0:i0 + n] = bmu[:n]
            self.models_lmap[i0:i0 + n] = lmap[:n]
            self.models_levid[i0:i0 + n] = levid[:n]

        if tail_idx:
            if tail_max > cap:
                raise ValueError(
                    "a model matched {} nodes (> max_nodes_per_model={}); "
                    "raise the cap or tighten wt_thresh".format(
                        tail_max, cap))
            tail = np.concatenate(tail_idx)
            cap2 = cap1
            while cap2 < tail_max:
                cap2 *= 2
            cap2 = min(cap2, cap)
            for j0, n in _batch_slices(len(tail), batch_size):
                rows = torch.as_tensor(tail[j0:j0 + n], device=self.device)
                out = dispatch(rows, cap2)
                collect(tail[j0:j0 + n], *(a[:n] for a in out[:5]))

        model_idx = np.concatenate(rows_l)
        node_idx = np.concatenate(cols).astype(np.int64)
        logwt = np.concatenate(lws)
        scale = np.concatenate(scs)
        serr = np.concatenate(ses)
        # Phase-2 entries arrive after every phase-1 entry: restore the
        # global model order, so each node's members keep the reference's
        # model-iteration order (networks.py:347-354).
        if tail_idx:
            om = np.argsort(model_idx, kind="stable")
            model_idx, node_idx, logwt, scale, serr = (
                model_idx[om], node_idx[om], logwt[om], scale[om], serr[om])

        self.nodes_Nmatch = np.bincount(node_idx,
                                        minlength=nnode).astype(np.int32)
        maxm = max(int(self.nodes_Nmatch.max()), 1)
        self.nodes_idxs = np.full((nnode, maxm), -99, np.int32)
        self.nodes_logwts = np.full((nnode, maxm), -np.inf, np.float32)
        self.nodes_scales = np.ones((nnode, maxm), np.float32)
        self.nodes_scales_err = np.zeros((nnode, maxm), np.float32)
        order = np.argsort(node_idx, kind="stable")
        sorted_nodes = node_idx[order]
        starts = np.searchsorted(sorted_nodes, np.arange(nnode))
        slot = np.arange(len(node_idx)) - starts[sorted_nodes]
        self.nodes_idxs[sorted_nodes, slot] = model_idx[order]
        self.nodes_logwts[sorted_nodes, slot] = logwt[order]
        self.nodes_scales[sorted_nodes, slot] = scale[order]
        self.nodes_scales_err[sorted_nodes, slot] = serr[order]

        self.nodes_Nbmu = np.bincount(bmus, minlength=nnode).astype(np.int32)
        maxb = max(int(self.nodes_Nbmu.max()), 1)
        self.nodes_bmus = np.full((nnode, maxb), -99, np.int32)
        order_b = np.argsort(bmus, kind="stable")
        sorted_b = bmus[order_b]
        starts_b = np.searchsorted(sorted_b, np.arange(nnode))
        slot_b = np.arange(self.NMODEL) - starts_b[sorted_b]
        self.nodes_bmus[sorted_b, slot_b] = order_b.astype(np.int32)
        return self

    # ------------------------------------------------------------------
    # node access / node PDFs
    # ------------------------------------------------------------------

    def get_node(self, idx=None, pos=None, discrete=False):
        """Quantities of one node (networks.py:358-410): (idx, node,
        node_pos, member_idxs, member_logwts, scales, scale_errs), the
        valid member prefix only."""
        if (idx is None) == (pos is None):
            raise ValueError("Exactly one of `idx` or `pos` must be given.")
        if pos is not None:
            idx = int(np.argmin(((np.asarray(self.nodes_pos)
                                  - np.asarray(pos)) ** 2).sum(axis=1)))
        if discrete:
            n = self.nodes_Nbmu[idx]
            idxs = self.nodes_bmus[idx, :n]
            logwts = np.zeros(n)
            scales = np.ones(n)
            serr = np.zeros(n)
        else:
            n = self.nodes_Nmatch[idx]
            idxs = self.nodes_idxs[idx, :n]
            logwts = self.nodes_logwts[idx, :n]
            scales = self.nodes_scales[idx, :n]
            serr = self.nodes_scales_err[idx, :n]
        return (idx, np.asarray(self.nodes)[idx],
                np.asarray(self.nodes_pos)[idx], idxs, logwts, scales, serr)

    def get_pdfs(self, model_labels, model_label_errs, label_dict=None,
                 label_grid=None, kde_args=None, kde_kwargs=None,
                 return_gof=False, discrete=False, verbose=True,
                 batch_size=256):
        """Per-node member-stacked label PDFs (Nnode, Ngrid)
        (networks.py:509-694): each node's weighted KDE over its members,
        normalized and then scaled by exp(levid); empty nodes get zero
        PDFs and -inf GOF.  The gathered stack bounds its (B, maxm,
        Ngrid) temporary by object chunks (`ops.kde.GATHER_ELEMS`)."""
        if label_dict is None and label_grid is None:
            raise ValueError("`label_dict` or `label_grid` must be "
                             "specified.")
        dx, sig_thresh, wt_thresh, cdf_thresh = _kde.resolve_kde_opts(
            kde_args, kde_kwargs)
        if discrete:
            idx_tab = self.nodes_bmus
            counts = self.nodes_Nbmu
            lw_tab = np.where(idx_tab >= 0, 0.0, -np.inf).astype(np.float32)
        else:
            idx_tab = self.nodes_idxs
            counts = self.nodes_Nmatch
            lw_tab = self.nodes_logwts
        nnode = idx_tab.shape[0]
        use_dict, ngrid, lab = _kde.pack_label_spec(
            label_dict, label_grid, model_labels, model_label_errs, dx=dx,
            sig_thresh=sig_thresh, device=self.device, dtype=self._dtype)
        idx_all = self._tensor(idx_tab.astype(np.int64))
        lw_all = self._tensor(lw_tab)

        pdfs = np.zeros((nnode, ngrid), np.float32)
        lmap = np.full(nnode, -np.inf, np.float32)
        levid = np.full(nnode, -np.inf, np.float32)
        for i0, n in progress_iter(_batch_slices(nnode, batch_size),
                                   total=nnode, label="Generating node PDF",
                                   verbose=verbose, sizes=True):
            sl = slice(i0, i0 + n)
            lm, lv, wt = _node_pdf_weights(lw_all[sl])
            wt = _kde.threshold_weights(wt, wt_thresh, cdf_thresh)
            pdf = _density_scale(
                _knn._gathered_pdf(use_dict, lab, ngrid, idx_all[sl], wt),
                lv)
            pdfs[sl] = pdf.cpu().numpy()
            lmap[sl] = lm.cpu().numpy()
            levid[sl] = lv.cpu().numpy()
        empty = counts == 0
        pdfs[empty] = 0.0
        lmap[empty] = -np.inf
        levid[empty] = -np.inf
        if return_gof:
            return pdfs, (lmap, levid)
        return pdfs

    def get_pdf(self, idx, model_labels, model_label_errs, label_dict=None,
                label_grid=None, kde_args=None, kde_kwargs=None,
                return_gof=False, discrete=False):
        """One node's PDF (networks.py:412-507)."""
        out = self.get_pdfs(model_labels, model_label_errs,
                            label_dict=label_dict, label_grid=label_grid,
                            kde_args=kde_args, kde_kwargs=kde_kwargs,
                            return_gof=return_gof, discrete=discrete,
                            verbose=False)
        if return_gof:
            pdfs, (lmap, levid) = out
            return pdfs[idx], (lmap[idx], levid[idx])
        return out[idx]

    # ------------------------------------------------------------------
    # fit / predict
    # ------------------------------------------------------------------

    def _occupied(self):
        if self.nodes_Nmatch is None:
            raise RuntimeError("populate_network() must run before fit()")
        sel = np.flatnonzero(self.nodes_Nmatch > 0)
        if len(sel) == 0:
            raise RuntimeError(
                "no occupied nodes — populate_network found no finite "
                "model-node fits (zero model errors with the default "
                "free-scale likelihood give 0/0 variances; pass nonzero "
                "models_err)")
        return sel

    def fit(self, data, data_err, data_mask, lprob_func=None,
            nodes_only=False, wt_thresh=1e-3, cdf_thresh=2e-4,
            lprob_args=None, lprob_kwargs=None, track_scale=False,
            discrete=False, verbose=True, batch_size=256,
            max_sel_nodes=24, max_neighbors=4096, checkpoint_every=None,
            checkpoint_file=None, resume=False):
        """Fit data against the network (networks.py:696-936).

        ``nodes_only=True``: `fit_lnprob` is the dense (Ndata, Nocc)
        thresholded node log-posterior grid over the occupied nodes
        (`self.neighbors` holds their ids).  ``nodes_only=False``: per
        object, the union of the members of its strongest `max_sel_nodes`
        selected nodes (at most `max_neighbors`, else ValueError),
        evaluated exactly with `lprob_func`, in kNN-style padded grids.

        ``checkpoint_every=N`` saves the fit prefix every N batches
        (`utils.checkpoint`); ``resume=True`` continues from an existing
        checkpoint bit for bit.
        """
        (data, _, _), (x_all, xe_all, xm_all) = self._data(data, data_err,
                                                            data_mask)
        ndata = data.shape[0]
        done = resume_fit_rows(self, resume, checkpoint_file, ndata,
                               checkpoint_every)
        self.NDATA = ndata
        self._fit_rows_done = done
        self.nodes_only = nodes_only
        occ = self._occupied()
        nocc = len(occ)
        nodes_occ = self._nodes_tensor()[self._tensor(occ)]
        lpnet_spec = self._lpnet_spec()
        nb = 0

        def batches(label):
            for i0, n in progress_iter(
                    _batch_slices(ndata, batch_size), total=ndata,
                    label=label, verbose=verbose, sizes=True):
                if i0 + n <= done:
                    continue
                yield i0, n, tuple(_pad_rows(t[i0:i0 + n], batch_size)
                                   for t in (x_all, xe_all, xm_all))

        def batch_done(i0, n):
            nonlocal nb
            self._fit_rows_done = i0 + n
            nb += 1
            if checkpoint_every and nb % checkpoint_every == 0:
                _ckpt.save(checkpoint_file, self)

        def host(t, n, dt=np.float32):
            return t[:n].cpu().numpy().astype(dt)

        if nodes_only:
            if not done:
                self.neighbors = occ.astype(np.int32)
                self.Nneighbors = np.full(ndata, nocc, np.int32)
                self.fit_lnprior = np.zeros((ndata, nocc), np.float32)
                self.fit_lnlike = np.zeros((ndata, nocc), np.float32)
                self.fit_lnprob = np.full((ndata, nocc), -np.inf,
                                          np.float32)
                self.fit_Ndim = np.zeros((ndata, nocc), np.int32)
                self.fit_chi2 = np.full((ndata, nocc), np.inf, np.float32)
                if track_scale:
                    self.fit_scale = np.ones((ndata, nocc), np.float32)
                    self.fit_scale_err = np.zeros((ndata, nocc),
                                                  np.float32)
            for i0, n, (x, xe, xm) in batches("Fitting object"):
                res, sel = _node_fit(x, xe, xm, nodes_occ,
                                     lpnet_spec=lpnet_spec,
                                     wt_thresh=wt_thresh,
                                     cdf_thresh=cdf_thresh)
                sl = slice(i0, i0 + n)
                self.fit_lnprob[sl] = np.where(host(sel, n, bool),
                                               host(res[2], n), -np.inf)
                self.fit_lnprior[sl] = host(res[0], n)
                self.fit_lnlike[sl] = host(res[1], n)
                self.fit_Ndim[sl] = host(res[3], n, np.int32)
                self.fit_chi2[sl] = host(res[4], n)
                if track_scale and len(res) > 5 and res[5] is not None:
                    self.fit_scale[sl] = host(res[5], n)
                    self.fit_scale_err[sl] = host(res[6], n)
                batch_done(i0, n)
            return self

        # --- exact-union path ---
        member_tab = self.nodes_bmus if discrete else self.nodes_idxs
        members = self._tensor(member_tab[occ].astype(np.int64))
        cap_sel = min(max_sel_nodes, nocc)
        shape = (ndata, max_neighbors)
        if not done:
            self.neighbors = np.full(shape, -99, np.int32)
            self.Nneighbors = np.zeros(ndata, np.int32)
            self.fit_lnprior = np.full(shape, -np.inf, np.float32)
            self.fit_lnlike = np.full(shape, -np.inf, np.float32)
            self.fit_lnprob = np.full(shape, -np.inf, np.float32)
            self.fit_Ndim = np.zeros(shape, np.int32)
            self.fit_chi2 = np.full(shape, np.inf, np.float32)
            self.fit_scale = (np.ones(shape, np.float32) if track_scale
                              else None)
            self.fit_scale_err = (np.zeros(shape, np.float32)
                                  if track_scale else None)
        lprob_spec = _like.static_spec(lprob_func, lprob_args, lprob_kwargs)
        for i0, n, (x, xe, xm) in batches("Fitting object"):
            idx, nuniq = _gather_union(
                x, xe, xm, nodes_occ, members, lpnet_spec=lpnet_spec,
                wt_thresh=wt_thresh, cdf_thresh=cdf_thresh, cap_sel=cap_sel,
                max_neighbors=max_neighbors)
            nu = host(nuniq, n, np.int32)
            if (nu > max_neighbors).any():
                raise _union_error(nu, max_neighbors)
            res = _knn._gathered_lprob(
                x, xe, xm, idx, idx >= 0, self.models, self.models_err,
                self.models_mask, lprob_spec=lprob_spec)
            sl = slice(i0, i0 + n)
            self.Nneighbors[sl] = nu
            # Columns past the widest union (rounded up to 128) keep the
            # preallocated pads, which equal the masked slots' values.
            w = min(max_neighbors, -(-max(int(nu.max(initial=1)), 1)
                                     // 128) * 128)
            self.neighbors[sl, :w] = host(idx[:, :w], n, np.int32)
            for name, k, dt in (("fit_lnprior", 0, np.float32),
                                ("fit_lnlike", 1, np.float32),
                                ("fit_lnprob", 2, np.float32),
                                ("fit_Ndim", 3, np.int32),
                                ("fit_chi2", 4, np.float32)):
                getattr(self, name)[sl, :w] = host(res[k][:, :w], n, dt)
            if track_scale and res[5] is not None:
                self.fit_scale[sl, :w] = host(res[5][:, :w], n)
                self.fit_scale_err[sl, :w] = host(res[6][:, :w], n)
            batch_done(i0, n)
        return self

    def predict(self, model_labels, model_label_errs, label_dict=None,
                label_grid=None, logwt=None, kde_args=None, kde_kwargs=None,
                return_gof=False, discrete=False, verbose=True,
                batch_size=256, wt_thresh=1e-3, cdf_thresh=2e-4):
        """PDFs from stored fits (networks.py:938-1128): nodes_only fits
        stack the node PDFs with the node weights (one matmul per batch);
        exact-union fits stack each object's member kernels."""
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
        logwt = np.asarray(logwt, np.float32)
        ndata = logwt.shape[0]

        if self.nodes_only:
            node_pdfs = self.get_pdfs(model_labels, model_label_errs,
                                      label_dict=label_dict,
                                      label_grid=label_grid,
                                      kde_args=kde_args,
                                      kde_kwargs=kde_kwargs,
                                      discrete=discrete, verbose=False)
            node_pdfs_occ = self._tensor(node_pdfs[self.neighbors])
            ngrid = node_pdfs.shape[1]
            pdfs = np.zeros((ndata, ngrid), np.float32)
            lmap = np.zeros(ndata, np.float32)
            levid = np.zeros(ndata, np.float32)
            for i0, n in progress_iter(
                    _batch_slices(ndata, batch_size), total=ndata,
                    label="Generating PDF", verbose=verbose, sizes=True):
                sl = slice(i0, i0 + n)
                out = _stack_node_pdfs(self._tensor(logwt[sl]),
                                       node_pdfs_occ)
                pdfs[sl], lmap[sl], levid[sl] = (t.cpu().numpy()
                                                 for t in out)
            if return_gof:
                return pdfs, (lmap, levid)
            return pdfs

        neighbors = self.neighbors
        if self.Nneighbors is not None and logwt.shape == neighbors.shape:
            # Trim to the widest union (128-aligned): the padded columns
            # carry zero weight.
            w = min(neighbors.shape[1],
                    -(-max(int(self.Nneighbors.max()), 1) // 128) * 128)
            neighbors = neighbors[:, :w]
            logwt = logwt[:, :w]
        pdfs, lmap, levid, _ = _knn.stack_batches(
            logwt, neighbors, model_labels, model_label_errs, label_dict,
            label_grid, wt_thresh, cdf_thresh, batch_size, dx=dx,
            sig_thresh=sig_thresh, device=self.device, dtype=self._dtype)
        if return_gof:
            return pdfs, (lmap, levid)
        return pdfs

    def fit_predict(self, data, data_err, data_mask, model_labels,
                    model_label_errs, lprob_func=None, label_dict=None,
                    label_grid=None, kde_args=None, kde_kwargs=None,
                    lprob_args=None, lprob_kwargs=None, return_gof=False,
                    track_scale=False, discrete=False, nodes_only=False,
                    verbose=True, save_fits=True, batch_size=256,
                    wt_thresh=1e-3, cdf_thresh=2e-4, max_sel_nodes=24,
                    max_neighbors=4096, mesh=None, _post_setup=None):
        """fit + predict (networks.py:1130-1487).  ``save_fits=True`` (the
        reference default) is fit() then predict(), with the padded fit
        grids on the host; ``save_fits=False`` streams each batch through
        node fit -> (member union -> exact posterior ->) PDFs on the
        device, and only (pdf, lmap, levid) come back.

        With `mesh` (a `parallel.Mesh`; needs ``save_fits=False``) each
        batch, its size rounded up to a multiple of ``mesh.size``, splits
        into one row block a shard, each run on its device with the
        nodes, node PDFs, member tables, models and labels copied there;
        a one-shard mesh gives the single-device result bit for bit."""
        if mesh is not None:
            _mesh.check_mesh(mesh)
            if save_fits:
                raise ValueError("mesh-sharded fit_predict streams PDFs "
                                 "only; pass save_fits=False")
        if _post_setup is not None and save_fits:
            raise ValueError("streaming summaries require the fused "
                             "save_fits=False path")
        if save_fits:
            self.fit(data, data_err, data_mask, lprob_func=lprob_func,
                     nodes_only=nodes_only, wt_thresh=wt_thresh,
                     cdf_thresh=cdf_thresh, lprob_args=lprob_args,
                     lprob_kwargs=lprob_kwargs, track_scale=track_scale,
                     discrete=discrete, verbose=verbose,
                     batch_size=batch_size, max_sel_nodes=max_sel_nodes,
                     max_neighbors=max_neighbors)
            return self.predict(model_labels, model_label_errs,
                                label_dict=label_dict, label_grid=label_grid,
                                kde_args=kde_args, kde_kwargs=kde_kwargs,
                                return_gof=return_gof, discrete=discrete,
                                verbose=verbose, batch_size=batch_size,
                                wt_thresh=wt_thresh, cdf_thresh=cdf_thresh)
        return self._fit_predict_fused(
            data, data_err, data_mask, model_labels, model_label_errs,
            lprob_func=lprob_func, label_dict=label_dict,
            label_grid=label_grid, kde_args=kde_args, kde_kwargs=kde_kwargs,
            lprob_args=lprob_args, lprob_kwargs=lprob_kwargs,
            return_gof=return_gof, discrete=discrete, nodes_only=nodes_only,
            batch_size=batch_size, wt_thresh=wt_thresh,
            cdf_thresh=cdf_thresh, max_sel_nodes=max_sel_nodes,
            max_neighbors=max_neighbors, mesh=mesh, verbose=verbose,
            post_setup=_post_setup)

    def _fit_predict_fused(self, data, data_err, data_mask, model_labels,
                           model_label_errs, lprob_func, label_dict,
                           label_grid, kde_args, kde_kwargs, lprob_args,
                           lprob_kwargs, return_gof, discrete, nodes_only,
                           batch_size, wt_thresh, cdf_thresh,
                           max_sel_nodes, max_neighbors, mesh=None,
                           verbose=True, post_setup=None):
        """save_fits=False streaming fit_predict (see fit_predict)."""
        (data, _, _), (x_all, xe_all, xm_all) = self._data(data, data_err,
                                                            data_mask)
        ndata = data.shape[0]
        devices = (self.models.device,) if mesh is None else mesh.devices
        batch_size = -(-batch_size // len(devices)) * len(devices)
        occ = self._occupied()
        nocc = len(occ)
        nodes_occ = self._nodes_tensor()[self._tensor(occ)]
        lpnet_spec = self._lpnet_spec()
        dx, sig_thresh, kde_wt, kde_cdf = _kde.resolve_kde_opts(
            kde_args, kde_kwargs, wt_thresh, cdf_thresh)

        if nodes_only:
            node_pdfs = self.get_pdfs(model_labels, model_label_errs,
                                      label_dict=label_dict,
                                      label_grid=label_grid,
                                      kde_args=kde_args,
                                      kde_kwargs=kde_kwargs,
                                      discrete=discrete, verbose=False)
            node_pdfs_occ = self._tensor(node_pdfs[occ])
            ngrid = node_pdfs.shape[1]
            shared = (nodes_occ, node_pdfs_occ)

            def run(x, xe, xm, rep):
                return _nodes_only_fp(
                    x, xe, xm, *rep, lpnet_spec=lpnet_spec,
                    wt_thresh=wt_thresh, cdf_thresh=cdf_thresh) + (None,)
        else:
            member_tab = self.nodes_bmus if discrete else self.nodes_idxs
            members = self._tensor(member_tab[occ].astype(np.int64))
            cap_sel = min(max_sel_nodes, nocc)
            lprob_spec = _like.static_spec(lprob_func, lprob_args,
                                           lprob_kwargs)
            use_dict, ngrid, lab = _kde.pack_label_spec(
                label_dict, label_grid, model_labels, model_label_errs,
                dx=dx, sig_thresh=sig_thresh, device=self.device,
                dtype=self._dtype)

            shared = (nodes_occ, members, self.models, self.models_err,
                      self.models_mask, lab)

            def run(x, xe, xm, rep):
                return _union_fp(
                    x, xe, xm, *rep, lpnet_spec=lpnet_spec,
                    lprob_spec=lprob_spec, wt_thresh=wt_thresh,
                    cdf_thresh=cdf_thresh, cap_sel=cap_sel,
                    max_neighbors=max_neighbors, kde_wt_thresh=kde_wt,
                    kde_cdf_thresh=kde_cdf, use_dict=use_dict, ngrid=ngrid)

        reps = _mesh.per_device(devices,
                                lambda dev: _mesh.to_device(shared, dev))
        post, out_width = ((None, ngrid) if post_setup is None
                           else post_setup(ndata, batch_size))
        pdfs = np.zeros((ndata, out_width), np.float32)
        lmap = np.zeros(ndata, np.float32)
        levid = np.zeros(ndata, np.float32)
        per = batch_size // len(devices)
        for i0, n in progress_iter(
                _batch_slices(ndata, batch_size), total=ndata,
                label="Generating PDF", verbose=verbose, sizes=True):
            batch = [_pad_rows(t[i0:i0 + n], batch_size)
                     for t in (x_all, xe_all, xm_all)]
            outs = []
            for k, (dev, rep) in enumerate(zip(devices, reps)):
                x, xe, xm = (t[k * per:(k + 1) * per].to(dev)
                             for t in batch)
                outs.append(run(x, xe, xm, rep))
            for k, (pdf_b, lmap_b, levid_b, nuniq) in enumerate(outs):
                j0 = i0 + k * per
                m = min(per, i0 + n - j0)
                if m <= 0:
                    continue
                if nuniq is not None:
                    nu = nuniq[:m].cpu().numpy()
                    if (nu > max_neighbors).any():
                        raise _union_error(nu, max_neighbors)
                if post is not None:
                    pdf_b = post(pdf_b, j0)
                sl = slice(j0, j0 + m)
                pdfs[sl] = pdf_b[:m].cpu().numpy()
                lmap[sl] = lmap_b[:m].cpu().numpy()
                levid[sl] = levid_b[:m].cpu().numpy()
        if return_gof:
            return pdfs, (lmap, levid)
        return pdfs

    def fit_summarize(self, data, data_err, data_mask, model_labels,
                      model_label_errs, lprob_func=None, label_dict=None,
                      label_grid=None, kde_args=None, kde_kwargs=None,
                      lprob_args=None, lprob_kwargs=None, discrete=False,
                      nodes_only=False, verbose=True, batch_size=256,
                      wt_thresh=1e-3, cdf_thresh=2e-4, max_sel_nodes=24,
                      max_neighbors=4096, mesh=None, pkern="lorentz",
                      pkern_grid=None, summary_seed=0):
        """Streaming `fit_predict(save_fits=False)` + `pdfs_summarize` on
        the device: only the 21 summary columns per object come back (the
        MC uniforms of `BruteForce.fit_summarize`).  Returns
        ``(PDFSummary, (lmap, levid))``."""
        grid = _summ.label_grid_of(label_dict, label_grid)
        cols, gof = self.fit_predict(
            data, data_err, data_mask, model_labels, model_label_errs,
            lprob_func=lprob_func, label_dict=label_dict,
            label_grid=label_grid, kde_args=kde_args, kde_kwargs=kde_kwargs,
            lprob_args=lprob_args, lprob_kwargs=lprob_kwargs,
            return_gof=True, discrete=discrete, nodes_only=nodes_only,
            verbose=verbose, save_fits=False, batch_size=batch_size,
            wt_thresh=wt_thresh, cdf_thresh=cdf_thresh,
            max_sel_nodes=max_sel_nodes, max_neighbors=max_neighbors,
            mesh=mesh, _post_setup=_summ.stream_summary_setup(
                grid, pkern, pkern_grid, summary_seed, device=self.device))
        return _summ.unpack_summary(cols), gof


# ----------------------------------------------------------------------
# SelfOrganizingMap
# ----------------------------------------------------------------------

def som_kernel_draws(models, models_err, models_mask, draws):
    """The kernel route's draws (networks.py:1615-1623): the drawn rows
    in float32, cleaned (non-finite, non-positive-error or masked bands:
    x = 0, iv = 0) for the likelihood, raw for the update.  Returns NumPy
    (xc, iv, x_raw), each (T, F) float32."""
    x = models[draws].astype(np.float32)
    xe = models_err[draws].astype(np.float32)
    xm = models_mask[draws].astype(np.float32)
    ok = np.isfinite(x) & np.isfinite(xe) & (xe > 0) & (xm == 1)
    iv = np.where(ok, 1.0 / np.where(ok, xe, 1.0) ** 2, 0.0).astype(
        np.float32)
    xc = np.where(ok, x, 0.0).astype(np.float32)
    return xc, iv, x


def _som_step_general(nodes, x, xe, xm, t, positions, nside, *, lprob_spec,
                      learn, neighbor, wt_thresh, cdf_thresh, track_scale):
    """One step of the general route (`_som_train_jit`'s scan body,
    networks.py:1238-1262)."""
    lprob_func, lprob_args, lp_kw = lprob_spec
    res = (lprob_func or _like.logprob)(
        x[None], xe[None], xm[None], nodes, torch.zeros_like(nodes),
        torch.ones_like(nodes), *lprob_args, **dict(lp_kw))
    lnp = res[2][0]
    if track_scale:
        nodes = nodes * res[5][0][:, None]
    bmu = torch.argmax(lnp)
    learn_fn, learn_args, learn_kw = learn
    rate = learn_fn(t, *learn_args, **learn_kw)
    nb_fn, nb_args, nb_kw = neighbor
    wt, _ = nb_fn(t, positions[bmu], positions, nside, *nb_args, **nb_kw)
    if wt_thresh is not None:
        keep = wt > wt_thresh * wt.amax()
    else:
        prob = wt / wt.sum()
        order = torch.sort(wt, stable=True).indices
        keep_sorted = torch.cumsum(prob[order], dim=0) <= (1.0 - cdf_thresh)
        keep = torch.zeros_like(keep_sorted).scatter(0, order, keep_sorted)
    update = rate * wt[:, None] * (x[None, :] - nodes)
    return nodes + torch.where(keep[:, None], update, 0.0)


def _som_train_general(nodes, draws, times, mods, errs, mask, positions,
                       nside, **kw):
    """The general route over one segment of the run: a step loop over
    `_som_step_general` (the counterpart of `_som_train_jit`)."""
    for idx, t in zip(draws.tolist(), times):
        nodes = _som_step_general(nodes, mods[idx], errs[idx], mask[idx], t,
                                  positions, nside, **kw)
    return nodes


def _training_start(checkpoint_every, checkpoint_file, resume, nsteps):
    """(restored state or None, steps done) of a training run cut into
    segments (networks.py:1538-1552, :2428-2447): validates the save plan,
    and with `resume` restores an existing checkpoint of the same run."""
    _ckpt.validate_plan(checkpoint_every, checkpoint_file)
    if not resume:
        return None, 0
    if not checkpoint_file:
        raise ValueError("resume=True requires checkpoint_file")
    if not _ckpt.exists(checkpoint_file):
        return None, 0
    st = _ckpt.restore(checkpoint_file)
    if int(st["nsteps_total"]) != nsteps:
        raise ValueError("checkpoint was taken for a "
                         f"{int(st['nsteps_total'])}-step run, "
                         f"resuming one of {nsteps}")
    return st, int(st["steps_done"])


class SelfOrganizingMap(_Network):
    """Classic SOM trained with log-posterior BMU matching (reference
    networks.py:1490-1867).  Defaults: 50x50 lattice (nside=50, nproj=2),
    niter=2000 x nbatch=50 = 100,000 sequential steps, free-scale
    error-free colour likelihood, harmonic learning rate, Gaussian
    neighbourhood.  On eligible configurations the whole training run is
    one launch of the `som_train` kernel (K8); ``use_kernel`` controls
    the route.
    """

    def train_network(self, models=None, models_err=None, models_mask=None,
                      nside=50, nproj=2, nodes_init=None, niter=2000,
                      nbatch=50, err_kernel=None, lprob_func=None,
                      learn_func=None, neighbor_func=None, wt_thresh=1e-3,
                      cdf_thresh=2e-4, rng=None, seed=None,
                      lprob_args=None, lprob_kwargs=None, track_scale=False,
                      learn_args=None, learn_kwargs=None, neighbor_args=None,
                      neighbor_kwargs=None, verbose=True, use_kernel=None,
                      checkpoint_every=None, checkpoint_file=None,
                      resume=False):
        """Train the map (networks.py:1682-1867).

        The draws are those of the JAX package: ``rng.choice`` picks the
        initial nodes (unless `nodes_init`), then ``rng.integers`` the
        niter*nbatch training rows, from ``rng`` or
        ``np.random.default_rng(seed)``.  ``use_kernel=None`` takes the
        kernel route when the configuration is eligible (the default
        free-scale error-free likelihood, optionally without the dim
        prior; named learn / neighbour schedules; `wt_thresh` mode; no
        `track_scale`; nproj <= 8, F <= 120, at most 32,768 nodes): on
        the card the CUDA kernel, on CPU tensors its plain version; else
        the general route, a step loop over `lprob_func`.
        ``use_kernel=True`` raises ValueError on an ineligible
        configuration; ``use_kernel=False`` takes the general route.

        ``checkpoint_every=S`` runs the training in S-step segments and
        saves the node table (`nodes`, `steps_done`, `nsteps_total`, the
        JAX package's keys) to `checkpoint_file` after each; the kernel
        route launches `som_train` once a segment with ``off`` the
        segment's first step, so the schedules run as in one launch.
        ``resume=True`` (the same seed, so the same draws) continues from
        the saved state.  Either way the nodes equal one uninterrupted
        call bit for bit.
        """
        if models is None:
            models = self._models_np
            models_err = self._models_err_np
            models_mask = self._models_mask_np
        models = np.asarray(models, float)
        models_err = np.asarray(models_err, float)
        models_mask = np.asarray(models_mask, float)
        if err_kernel is not None:
            models_err = np.sqrt(models_err**2 + np.asarray(err_kernel)**2)
        nmodel, nfilt = models.shape
        self.NITER, self.NBATCH = niter, nbatch
        self.NSIDE = nside
        self.NNODE, self.NPROJ = nside**nproj, nproj

        if lprob_func is None:
            lprob_func = _like.logprob
        lprob_args = lprob_args or ()
        if lprob_kwargs is None:
            lprob_kwargs = {"free_scale": True, "ignore_model_err": True}
            if track_scale:
                lprob_kwargs["return_scale"] = True
        learn_fn = learn_func or learn_harmonic
        learn_kwargs = learn_kwargs or {}
        learn_args = learn_args or ()
        neighbor_fn = neighbor_func or neighbor_gauss
        neighbor_kwargs = neighbor_kwargs or {}
        neighbor_args = neighbor_args or ()

        # Lattice positions: digit i of the node index in base nside
        # (networks.py:1804-1810).
        idxs = np.arange(self.NNODE)
        pos = np.zeros((self.NNODE, nproj))
        for i in range(nproj):
            pos[:, i] = (idxs // nside ** (nproj - 1 - i)) % nside
        self.nodes_pos = pos

        rng = rng if rng is not None else np.random.default_rng(seed)
        if nodes_init is None:
            init = models[rng.choice(nmodel, size=self.NNODE,
                                     replace=False)]
        else:
            init = np.asarray(nodes_init, float)
        nsteps = niter * nbatch
        t0 = time.time()
        draws = rng.integers(0, nmodel, size=nsteps)
        st, start = _training_start(checkpoint_every, checkpoint_file,
                                    resume, nsteps)
        if st is not None:
            init = np.asarray(st["nodes"], float)
        seg = int(checkpoint_every) if checkpoint_every else nsteps

        def segments():
            for s0 in range(start, nsteps, seg):
                yield s0, min(s0 + seg, nsteps)

        def saved(nodes, steps_done):
            if checkpoint_every:
                _ckpt.save(checkpoint_file, {
                    "nodes": nodes.cpu().numpy().astype(float),
                    "steps_done": int(steps_done),
                    "nsteps_total": int(nsteps)})

        lprob_spec = _like.static_spec(lprob_func, lprob_args, lprob_kwargs)
        kw = dict(lprob_spec[2])
        nb_rate = neighbor_kwargs.get("rate", "harmonic")
        kernel_ok = (
            lprob_spec[0] is None and not lprob_spec[1]
            and kw.get("free_scale") is True
            and kw.get("ignore_model_err") is True
            and set(kw) <= {"free_scale", "ignore_model_err", "dim_prior"}
            and not track_scale
            and wt_thresh is not None
            and learn_fn in _LEARN_NAMES and not learn_args
            and set(learn_kwargs) <= {"start", "end"}
            and neighbor_fn in (neighbor_gauss, neighbor_lorentz)
            and not neighbor_args
            and set(neighbor_kwargs) <= {"start", "end", "rate"}
            and isinstance(nb_rate, str) and nb_rate in _LEARN
            and nproj <= _som.MAX_PROJ and nfilt <= _som.MAX_FILT
            and self.NNODE <= _som.MAX_NODES)
        if use_kernel is None:
            use_kernel = kernel_ok
        elif use_kernel and not kernel_ok:
            raise ValueError(
                "use_kernel=True requires the default free-scale error-free "
                "likelihood, named learn/neighbor schedules, wt_thresh "
                "mode, no track_scale, nproj <= {}, <= {} filters and <= {} "
                "nodes (got {} nodes at {} filters)".format(
                    _som.MAX_PROJ, _som.MAX_FILT, _som.MAX_NODES, self.NNODE,
                    nfilt))

        if use_kernel:
            xc, iv, xr = (self._tensor(a) for a in som_kernel_draws(
                models, models_err, models_mask, draws))
            positions = self._tensor(pos.astype(np.float32))
            nodes = self._tensor(init.astype(np.float32))
            skw = dict(
                nside=nside, wt_thresh=wt_thresh,
                dim_prior=bool(kw.get("dim_prior", True)),
                lr=_som.schedule(_LEARN_NAMES[learn_fn],
                                 learn_kwargs.get("start", 0.5),
                                 learn_kwargs.get("end", 0.1)),
                nb=_som.schedule(nb_rate, neighbor_kwargs.get("start", 0.7),
                                 neighbor_kwargs.get("end", 0.02)),
                lorentz=neighbor_fn is neighbor_lorentz,
                nsteps_total=nsteps)
            for s0, s1 in segments():
                nodes, _ = _som.som_train(nodes, positions, xc[s0:s1],
                                          iv[s0:s1], xr[s0:s1], off=s0,
                                          **skw)
                saved(nodes, s1)
            self.nodes = nodes.cpu().numpy().astype(float)
            train_note(verbose, "SOM training (kernel)", nsteps, t0)
            return self

        f32 = torch.float32
        nodes = self._tensor(init, f32)
        mods, errs, mask = (self._tensor(a, f32)
                            for a in (models, models_err, models_mask))
        positions = self._tensor(pos, f32)
        times = self._tensor(np.linspace(0.0, 1.0, nsteps), f32)
        gkw = dict(lprob_spec=lprob_spec,
                   learn=(learn_fn, tuple(learn_args), dict(learn_kwargs)),
                   neighbor=(neighbor_fn, tuple(neighbor_args),
                             dict(neighbor_kwargs)),
                   wt_thresh=wt_thresh, cdf_thresh=cdf_thresh,
                   track_scale=bool(track_scale))
        for s0, s1 in segments():
            nodes = _som_train_general(nodes, draws[s0:s1], times[s0:s1],
                                       mods, errs, mask, positions, nside,
                                       **gkw)
            saved(nodes, s1)
        self.nodes = nodes.cpu().numpy().astype(float)
        train_note(verbose, "SOM training", nsteps, t0)
        return self


# ----------------------------------------------------------------------
# GrowingNeuralGas
# ----------------------------------------------------------------------

def _gng_seed_state(graph_init, max_nodes, nfilt, K=32):
    """The dense GNG state arrays of an initial graph (the port's copy of
    frankenz_tpu/models/networks.py:1917-2014).

    Accepted forms: a trained `GrowingNeuralGas` (``nodes`` /
    ``nodes_err`` / ``edge_ages``); a dict with ``pos`` (n, Nfilt),
    optional ``err`` (n,) and either ``edge_ages`` (n, n; -1 = no edge)
    or ``edges`` [(i, j, age), ...]; a networkx-like graph with node
    attribute ``pos`` (required), ``error`` (default 0) and edge
    attribute ``age`` (default 0), relabelled to dense slots in iteration
    order.  Ages are relative in the adjacency table (age = c - sref), so
    ``c = 0, sref = -age`` reproduces them.  Returns (pos0, err0, alive0,
    ids0, sref0, c0) over `max_nodes` slots.
    """
    if hasattr(graph_init, "edge_ages") and hasattr(graph_init, "nodes"):
        pos = np.asarray(graph_init.nodes, np.float32)
        err = np.asarray(getattr(graph_init, "nodes_err",
                                 np.zeros(len(pos))), np.float32)
        edges = _edges_of_ages(graph_init.edge_ages)
    elif isinstance(graph_init, dict):
        pos = np.asarray(graph_init["pos"], np.float32)
        err = np.asarray(graph_init.get("err", np.zeros(len(pos))),
                         np.float32)
        if "edge_ages" in graph_init:
            edges = _edges_of_ages(graph_init["edge_ages"])
        else:
            edges = [tuple(e) if len(e) == 3 else (e[0], e[1], 0)
                     for e in graph_init.get("edges", [])]
    elif hasattr(graph_init, "nodes") and hasattr(graph_init, "edges"):
        slot = {node: i for i, node in enumerate(graph_init.nodes())}
        pos_l, err_l = [], []
        for node in graph_init.nodes():
            attrs = graph_init.nodes[node]
            if "pos" not in attrs:
                raise ValueError(
                    f"graph_init node {node!r} lacks the 'pos' attribute")
            pos_l.append(np.asarray(attrs["pos"], np.float32))
            err_l.append(float(attrs.get("error", 0.0)))
        pos = np.stack(pos_l) if pos_l else np.zeros((0, nfilt), np.float32)
        err = np.asarray(err_l, np.float32)
        edges = [(slot[u], slot[v],
                  int(graph_init.edges[u, v].get("age", 0)))
                 for u, v in graph_init.edges()]
    else:
        raise TypeError(
            "graph_init must be a GrowingNeuralGas, a dict with "
            "pos/err/edge_ages (or edges), or a networkx.Graph with "
            "'pos'/'error'/'age' attributes; got "
            f"{type(graph_init).__name__}")

    n = len(pos)
    if n < 2:
        raise ValueError(f"graph_init needs at least 2 nodes, got {n}")
    if n > max_nodes:
        raise ValueError(f"graph_init has {n} nodes > max_nodes="
                         f"{max_nodes}")
    if pos.ndim != 2 or pos.shape[1] != nfilt:
        raise ValueError(f"graph_init node positions have shape "
                         f"{pos.shape}, expected (n, {nfilt})")

    pos0 = np.zeros((max_nodes, nfilt), np.float32)
    pos0[:n] = pos
    err0 = np.zeros(max_nodes, np.float32)
    err0[:n] = err
    alive0 = np.zeros(max_nodes, bool)
    alive0[:n] = True
    ids0 = np.full((max_nodes, K), -1, np.int32)
    sref0 = np.zeros((max_nodes, K), np.int32)
    c0 = np.zeros(max_nodes, np.int32)
    deg = np.zeros(max_nodes, np.int64)
    for i, j, age in edges:
        i, j, age = int(i), int(j), int(age)
        for a, b in ((i, j), (j, i)):
            if deg[a] >= K:
                raise ValueError(
                    f"graph_init node {a} has more than {K} edges; the "
                    "fixed-degree adjacency cannot hold it")
            ids0[a, deg[a]] = b
            sref0[a, deg[a]] = -age
            deg[a] += 1
    return pos0, err0, alive0, ids0, sref0, c0


# A GNG run's carried state under the JAX package's checkpoint keys, with
# the dtypes the training routes take (networks.py:2440-2446).
_GNG_STATE = (("pos", np.float32), ("err", np.float32), ("alive", bool),
              ("ids", np.int32), ("sref", np.int32), ("c", np.int32))


def _edges_of_ages(edge_ages):
    """[(i, j, age)] with i < j of a dense age matrix (-1 = no edge)."""
    ages = np.asarray(edge_ages)
    ii, jj = np.nonzero(ages >= 0)
    keep = ii < jj
    return list(zip(ii[keep].tolist(), jj[keep].tolist(),
                    ages[ii[keep], jj[keep]].tolist()))


def _gng_remove(ids, i, j):
    """Clear the first slot holding j in node i's row (networks.py:
    1796-1802)."""
    row = ids[i]
    match = row == j
    slot = torch.argmax(match.to(torch.int32))
    ids[i, slot] = torch.where(match.any(), -1, row[slot])


def _gng_train_general(pos, err, alive, ids, sref, c, ov, draws, mods, errs,
                       mask, *, lprob_spec, track_scale, nbatch, max_age,
                       learn_best, learn_neighbor, new_err_dec, all_err_dec):
    """The general route: a step loop in torch, the counterpart of the
    scan `_gng_train_jit` (networks.py:1702-1914), in its order: the step,
    then the prune / insert at each block's first step, then the error
    decay.  Every tensor lives on the network's device; the state arrays
    are updated in place where the scan's `.at[]` updates them."""
    lprob_func, lprob_args, lp_kw = lprob_spec
    lprob_kwargs = dict(lp_kw)
    default_spec = (lprob_func is None and not lprob_args
                    and lprob_kwargs.get("free_scale") is True
                    and lprob_kwargs.get("ignore_model_err") is True
                    and set(lprob_kwargs) <= {"free_scale",
                                              "ignore_model_err",
                                              "dim_prior"})
    dim_prior = lprob_kwargs.get("dim_prior", True)
    lprob_func = lprob_func or _like.logprob
    N = pos.shape[0]
    dev = pos.device
    nodes = torch.arange(N, device=dev)
    ov = torch.as_tensor(ov, dtype=torch.int32, device=dev)

    def default_lnp_chi2(x, xe, xm):
        ok = (torch.isfinite(x) & torch.isfinite(xe) & (xe > 0.0)
              & (xm > 0.0))
        iv = torch.where(ok, 1.0 / torch.where(ok, xe, 1.0) ** 2, 0.0)
        xc = torch.where(ok, x, 0.0)
        xiv = xc * iv
        inter = pos @ xiv
        shape = (pos * pos) @ iv
        A = (xc * xiv).sum()
        chi2 = A - inter * (inter / shape.clamp_min(1e-30))
        if dim_prior:
            a1 = 0.5 * (ok.to(pos.dtype).sum() - 1.0) - 1.0
            score = a1 * torch.log(chi2.clamp_min(1e-30)) - 0.5 * chi2
        else:
            score = -0.5 * chi2
        return torch.where(alive, score, -torch.inf), chi2

    def step(idx):
        nonlocal pos, err, sref, c, ov
        x, xe, xm = mods[idx], errs[idx], mask[idx]
        if default_spec and not track_scale:
            lnp, chi2 = default_lnp_chi2(x, xe, xm)
        else:
            res = lprob_func(x[None], xe[None], xm[None], pos,
                             torch.zeros_like(pos), torch.ones_like(pos),
                             *lprob_args, **lprob_kwargs)
            lnp = torch.where(alive, res[2][0], -torch.inf)
            chi2 = res[4][0]
            if track_scale:
                pos = torch.where(alive[:, None],
                                  pos * res[5][0][:, None], pos)
        # The scan's compiled top_k orders floats by their bits, and the
        # NaN of a NaN node's score is negative there: it ranks last.
        top2 = _top_k(torch.where(torch.isnan(lnp), -torch.inf, lnp), 2)[1]
        bmu, bmu2 = top2[0], top2[1]
        pos[bmu] = pos[bmu] + learn_best * (x - pos[bmu])
        err[bmu] = err[bmu] + chi2[bmu]
        ov = ov + _gng._upsert(ids, sref, bmu, bmu2, c[bmu])
        ov = ov + _gng._upsert(ids, sref, bmu2, bmu, c[bmu2])
        row = ids[bmu]
        nbr = torch.zeros(N + 1, dtype=torch.bool, device=dev)
        nbr[torch.where(row >= 0, row, N).long()] = True
        nbr = nbr[:N]
        pos = pos + torch.where(nbr[:, None], learn_neighbor * (x - pos),
                                0.0)
        c = c + (nodes == bmu).to(c.dtype)
        sref = torch.where(ids == bmu, sref - 1, sref)

    def batch_update():
        nonlocal ids, alive, ov
        age = c[:, None] - sref
        ids = torch.where((ids >= 0) & (age >= max_age), -1, ids)
        alive = alive & (ids >= 0).any(dim=1)
        if int(alive.sum()) >= N:
            return
        e1 = int(torch.argmax(torch.where(alive, err, -torch.inf)))
        row = ids[e1]
        nbr_err = torch.where(row >= 0, err[row.clamp_min(0).long()],
                              -torch.inf)
        e2 = int(row[torch.argmax(nbr_err)])
        free = int(torch.argmin(alive.to(torch.int32)))
        err[e1] = err[e1] * (1.0 - new_err_dec)
        err[e2] = err[e2] * (1.0 - new_err_dec)
        pos[free] = 0.5 * (pos[e1] + pos[e2])
        err[free] = err[e1]
        alive[free] = True
        _gng_remove(ids, e1, e2)
        _gng_remove(ids, e2, e1)
        ids[free] = -1
        ov = ov + _gng._upsert(ids, sref, free, e1, c[free])
        ov = ov + _gng._upsert(ids, sref, free, e2, c[free])
        ov = ov + _gng._upsert(ids, sref, e1, free, c[e1])
        ov = ov + _gng._upsert(ids, sref, e2, free, c[e2])

    dec = 1.0 - all_err_dec
    for s, idx in enumerate(draws.tolist()):
        step(idx)
        if s % nbatch == 0:
            batch_update()
        err = err * dec
    return pos, err, alive, ids, sref, c, int(ov)


class GrowingNeuralGas(_Network):
    """Growing Neural Gas trained on log-posterior best-node pairs
    (reference networks.py:1870-2260).  The graph is fixed-capacity dense
    state: a (max_nodes, Nfilt) node table, accumulated errors, an alive
    mask and a 32-slot adjacency table with counter-based aging; per step
    the best node and the runner-up by log-posterior, the edge between
    them refreshed, the best node moved by learn_best and its neighbours
    by learn_neighbor, its edges aged; at each block's first step (every
    `nbatch` steps) overage edges are pruned, isolated nodes die and a
    node is inserted between the largest-error node and its largest-error
    neighbour; all errors decay every step.  On eligible configurations
    the whole run is one launch of the `gng_train` kernel (K9);
    ``use_kernel`` controls the route.
    """

    def train_network(self, models=None, models_err=None, models_mask=None,
                      niter=5000, nbatch=50, max_nodes=2500, max_age=15,
                      learn_best=0.2, learn_neighbor=0.005,
                      new_err_dec=0.5, all_err_dec=0.005, graph_init=None,
                      err_kernel=None, lprob_func=None, rng=None, seed=None,
                      lprob_args=None, lprob_kwargs=None, track_scale=False,
                      verbose=True, checkpoint_every=None,
                      checkpoint_file=None, resume=False, use_kernel=None):
        """Train the GNG (networks.py:2360-2616).

        The draws are those of the JAX package: ``rng.integers`` picks the
        niter*nbatch training rows, then ``rng.choice`` the two seed nodes
        (unless `graph_init`, a trained GNG, an `export_graph` dict or a
        networkx graph, continues an existing graph), from ``rng`` or
        ``np.random.default_rng(seed)``.  ``use_kernel=None`` takes the
        kernel route when the configuration is eligible (the default
        free-scale error-free likelihood, optionally without the dim
        prior; no `track_scale`; at most 32,768 nodes and 120 filters):
        on the card the CUDA kernel, on CPU tensors its plain version;
        else the general route, a step loop over `lprob_func`.
        ``use_kernel=True`` raises ValueError on an ineligible
        configuration; ``use_kernel=False`` takes the general route.

        ``checkpoint_every=S`` runs the training in segments of S steps
        rounded up to whole `nbatch` blocks (the insert / prune block
        fires on a call's first step) and saves the whole state (`pos`,
        `err`, `alive`, `ids`, `sref`, `c`, `overflow`, `steps_done`,
        `nsteps_total`, the JAX package's keys) to `checkpoint_file`
        after each; the kernel route launches `gng_train` once a
        segment.  ``resume=True`` (the same seed, so the same draws)
        continues from the saved state.  Either way the graph equals one
        uninterrupted call bit for bit.
        """
        if models is None:
            models = self._models_np
            models_err = self._models_err_np
            models_mask = self._models_mask_np
        models = np.asarray(models, float)
        models_err = np.asarray(models_err, float)
        models_mask = np.asarray(models_mask, float)
        if err_kernel is not None:
            models_err = np.sqrt(models_err**2 + np.asarray(err_kernel)**2)
        nmodel, nfilt = models.shape
        self.NITER, self.NBATCH = niter, nbatch

        if lprob_func is None:
            lprob_func = _like.logprob
        lprob_args = lprob_args or ()
        if lprob_kwargs is None:
            lprob_kwargs = {"free_scale": True, "ignore_model_err": True}
            if track_scale:
                lprob_kwargs["return_scale"] = True

        rng = rng if rng is not None else np.random.default_rng(seed)
        nsteps = niter * nbatch
        t0 = time.time()
        draws = rng.integers(0, nmodel, size=nsteps)
        N, K = max_nodes, _gng.K
        if graph_init is not None:
            state = _gng_seed_state(graph_init, N, nfilt, K)
        else:
            i1, i2 = rng.choice(nmodel, size=2, replace=False)
            pos0 = np.zeros((N, nfilt), np.float32)
            pos0[0], pos0[1] = models[i1], models[i2]
            alive0 = np.zeros(N, bool)
            alive0[:2] = True
            ids0 = np.full((N, K), -1, np.int32)
            ids0[0, 0], ids0[1, 0] = 1, 0
            state = (pos0, np.zeros(N, np.float32), alive0, ids0,
                     np.zeros((N, K), np.int32), np.zeros(N, np.int32))

        ov = 0
        st, start = _training_start(checkpoint_every, checkpoint_file,
                                    resume, nsteps)
        if st is not None:
            state = tuple(np.asarray(st[k], dt) for k, dt in _GNG_STATE)
            ov = int(st["overflow"])
        if checkpoint_every:
            seg = max(int(nbatch), -(-int(checkpoint_every) // int(nbatch))
                      * int(nbatch))
        else:
            seg = nsteps

        lprob_spec = _like.static_spec(lprob_func, lprob_args, lprob_kwargs)
        kw = dict(lprob_spec[2])
        kernel_ok = (
            lprob_spec[0] is None and not lprob_spec[1]
            and kw.get("free_scale") is True
            and kw.get("ignore_model_err") is True
            and set(kw) <= {"free_scale", "ignore_model_err", "dim_prior"}
            and not track_scale
            and 2 <= N <= _gng.MAX_NODES and nfilt <= _gng.MAX_FILT)
        if use_kernel is None:
            use_kernel = kernel_ok
        elif use_kernel and not kernel_ok:
            raise ValueError(
                "use_kernel=True requires the default free-scale error-free "
                "likelihood, no track_scale, 2 to {} nodes and <= {} "
                "filters (got {} nodes at {} filters)".format(
                    _gng.MAX_NODES, _gng.MAX_FILT, N, nfilt))
        consts = dict(nbatch=int(nbatch), max_age=int(max_age),
                      learn_best=float(learn_best),
                      learn_neighbor=float(learn_neighbor),
                      new_err_dec=float(new_err_dec),
                      all_err_dec=float(all_err_dec))

        out = tuple(self._tensor(a) for a in state) + (ov,)
        if use_kernel:
            xc, iv, xr = (self._tensor(a) for a in som_kernel_draws(
                models, models_err, models_mask, draws))

            def run(state, s0, s1):
                return _gng.gng_train(
                    *state, xc[s0:s1], iv[s0:s1], xr[s0:s1],
                    dim_prior=bool(kw.get("dim_prior", True)), **consts)
            label = "GNG training (kernel)"
        else:
            f32 = torch.float32
            arrays = tuple(self._tensor(a, f32) for a in (
                models, models_err, models_mask))

            def run(state, s0, s1):
                return _gng_train_general(
                    *state, draws[s0:s1], *arrays, lprob_spec=lprob_spec,
                    track_scale=bool(track_scale), **consts)
            label = "GNG training"
        for s0 in range(start, nsteps, seg):
            s1 = min(s0 + seg, nsteps)
            out = run(out, s0, s1)
            if checkpoint_every:
                _ckpt.save(checkpoint_file, dict(
                    {k: t.cpu().numpy() for (k, _), t in zip(_GNG_STATE,
                                                             out)},
                    overflow=int(out[6]), steps_done=int(s1),
                    nsteps_total=int(nsteps)))
        self._set_graph(*(o.cpu().numpy() if isinstance(o, torch.Tensor)
                          else o for o in out))
        train_note(verbose, label, nsteps, t0)
        return self

    def _set_graph(self, pos, err, alive, ids, sref, c, overflow):
        """The public attributes of a trained state (networks.py:
        2594-2614): alive nodes, their errors, the dense symmetric edge-age
        matrix over them (-1 = no edge), the overflow count."""
        N = len(pos)
        sel = np.flatnonzero(alive)
        self.nodes = np.asarray(pos)[sel].astype(float)
        self.nodes_err = np.asarray(err)[sel].astype(float)
        age = c[:, None] - sref
        full_ages = np.full((N, N), -1, np.int32)
        rows = np.repeat(np.arange(N), ids.shape[1])
        cols = ids.ravel()
        vmask = cols >= 0
        full_ages[rows[vmask], cols[vmask]] = age.ravel()[vmask]
        self.edge_overflow = int(overflow)
        self.edge_ages = full_ages[np.ix_(sel, sel)]
        self.NNODE = len(sel)
        self.NPROJ = self.nodes.shape[1]
        # No lattice: the first two feature dimensions stand in for
        # plotting positions.
        self.nodes_pos = (self.nodes[:, :2] if self.nodes.shape[1] >= 2
                          else self.nodes)

    def edges(self):
        """(Nedge, 2) array of alive-node edge index pairs (i < j)."""
        ii, jj = np.nonzero(self.edge_ages >= 0)
        keep = ii < jj
        return np.stack([ii[keep], jj[keep]], axis=1)

    def export_graph(self):
        """The trained graph as a ``graph_init``-ready dict (absolute
        ages, so reseeding keeps the pruning schedule)."""
        return {"pos": np.asarray(self.nodes, np.float32),
                "err": np.asarray(self.nodes_err, np.float32),
                "edge_ages": np.asarray(self.edge_ages)}
