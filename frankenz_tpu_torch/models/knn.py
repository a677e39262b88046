"""Pieces of the kNN fitter that the network fitters share.

Port of the parts of `frankenz_tpu.models.knn` (reference
`frankenz/knn.py`) that `_Network` needs: the posterior of each object
against its own gathered model subset (`_gathered_lprob`, the
counterpart of `_gathered_lprob_jit`, knn.py:76), the GOF weights of a
log-weight grid (`_gof_weights`, :115) and the stacking of stored fits
into PDFs (`stack_batches`, the body of `NearestNeighbors.
_stack_batches`, :553).  The `NearestNeighbors` fitter itself is not
ported yet.

Padding conventions of the per-object grids (knn.py:344-352): index
-99, lnprob -inf, chi2 +inf, Ndim 0, scale 1, scale error 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kde as _kde
from ..ops import likelihood as _like

__all__ = ["stack_batches"]


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
    """(lmap, levid, wt) of a log-weight grid (bruteforce.py:359-360)."""
    lmap = lnprob.amax(dim=1)
    levid = torch.logsumexp(lnprob, dim=1)
    return lmap, levid, torch.exp(lnprob - levid[:, None])


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
        safe = idx.clamp_min(0)
        if use_dict:
            sigmas, widths, delta, full_pos, full_sig = lab
            pdf = _kde._kde_stack_gathered(sigmas, widths, delta,
                                           full_pos[safe], full_sig[safe],
                                           wt, ngrid)
        else:
            labels, label_errs, grid_t, dxv, sthr = lab
            pdf = _kde._kde_stack_gathered_grid(labels[safe],
                                                label_errs[safe], wt, grid_t,
                                                dxv, sthr)
        pdfs[sl] = _kde.norm_rows(pdf).cpu().numpy()
        lmap[sl] = lm.cpu().numpy()
        levid[sl] = lv.cpu().numpy()
    return pdfs, lmap, levid, grid
