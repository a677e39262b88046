"""
Fused fit -> PDF for one object batch: chi^2 grid -> lmap / levid ->
thresholded weights -> KDE label PDFs, without the (B, M) grid in memory.

Port of `frankenz_tpu.ops.fused.fused_fit_pdf` for the route this
package has kernels for: full masks, dim prior, fixed scale, and
``wt_thresh`` set (or both thresholds None).  That route is the two-pass
pair of `frankenz_tpu/ops/fused.py:1688` (`_fused_call_fullmask_dimprior`):

  pass A (`kernels.fullmask.chi2_brackets`): per object, the chi^2 values
      bracketing c0 = F - 2, where the unimodal lnl(chi2) peaks;
  glue (plain torch, as it was XLA): lmap from the brackets, the shift
      floored at lnl(clamp);
  pass B (`kernels.fullmask.chi2_stack`): w = exp(lnl - lmap), the
      unthresholded sum s, pdf += (w > wt_thresh) @ G;
  glue: levid = log s + lmap, the PDF rescale, the degenerate-row rule.

Routing (`fused_route`): on CUDA the full-mask route launches the two
kernels and every other configuration raises `NotImplementedError`
naming the ROADMAP kernel that would serve it; on the CPU the full-mask
route runs the kernels' plain versions through the same glue and every
other configuration runs the plain composition (logprob, logsumexp,
threshold, `kde_stack`).  Nothing catches a failed build or launch.

One documented deviation, inherited from the JAX kernels: on rows whose
EVERY chi^2 exceeds the clamp (F <= 19, chi^2 > 30000: insane outliers)
lmap and levid stay float32-exact, but the PDF is a uniform mixture over
the clamped models instead of the plain path's argmax row
(`frankenz_tpu/ops/fused.py:2029-2035`).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import gammaln as _sp_gammaln

from ..kernels import build as _build
from ..kernels import fullmask as _fm
from . import kde as _kde
from . import likelihood as _like

__all__ = ["fused_fit_pdf", "fused_route", "kernels_available"]

_LOG_2 = 0.6931471805599453
_NEG_INF = float(np.finfo(np.float32).min)


def kernels_available():
    """True when this process can build and launch the CUDA kernels (a
    card and `nvcc`); the counterpart of `pallas_supported`."""
    return torch.cuda.is_available() and _build.nvcc_path() is not None


def fused_route(device_type, *, full_mask, dim_prior=True, free_scale=False,
                wt_thresh=1e-3, cdf_thresh=None):
    """Which implementation serves a `fused_fit_pdf` call.

    Returns "kernels" (the full-mask pair; on the CPU their plain
    versions) or "plain" (the plain composition, CPU only).  On CUDA a
    configuration whose JAX route is a Pallas kernel not ported yet
    raises `NotImplementedError` naming its ROADMAP entry.
    """
    cdf_mode = wt_thresh is None and cdf_thresh is not None
    if full_mask and dim_prior and not free_scale and not cdf_mode:
        return "kernels"
    if device_type != "cuda":
        return "plain"
    if free_scale:
        missing = "K6 (free-scale likelihood tile)"
    elif cdf_mode:
        missing = "K5 (cdf_thresh top-T and cut-stack kernels)"
    elif wt_thresh is None:
        missing = "K4 (one-pass kernel for wt_thresh=None)"
    else:
        missing = "K3 (masked / Normal-likelihood two-pass kernels)"
    raise NotImplementedError(
        "fused_fit_pdf on CUDA runs only the full-mask, dim-prior, "
        "fixed-scale route; this configuration needs ROADMAP kernel "
        f"{missing}, not ported yet (use_fused=False runs the plain "
        "composition on the card)")


def _lnl_of(c, a1, norm):
    """Full-mask dim-prior lnl at chi^2 = c."""
    safe = torch.where(c < 1e-30, 1e-30, c)
    return (a1 * torch.log(safe) if a1 != 0.0 else 0.0) - 0.5 * c - norm


def lmap_and_shift(below, above, nfilt):
    """lmap from pass A's chi^2 brackets, and pass B's exponent shift
    (ops/fused.py:1742-1759)."""
    a1 = 0.5 * nfilt - 1.0
    norm = float(_sp_gammaln(0.5 * nfilt) + _LOG_2 * 0.5 * nfilt)
    lmap = torch.maximum(
        torch.where(below >= 0.0, _lnl_of(below, a1, norm), -torch.inf),
        torch.where(torch.isfinite(above), _lnl_of(above, a1, norm),
                    -torch.inf))
    if a1 > _fm.A1_NOLOG_MAX:
        shift = lmap + norm
    else:
        # The no-log kernel clamps chi^2, so floor the shift at
        # lnl(clamp): rows whose every model clamps get w = 1 per pair
        # instead of exp overflow.
        lnl_clamp = float((a1 * np.log(_fm.CHI2_CLAMP) if a1 else 0.0)
                          - 0.5 * _fm.CHI2_CLAMP - norm)
        shift = torch.clamp_min(lmap, lnl_clamp) + norm
    return lmap, shift.contiguous()


def _fullmask_dimprior(d, de, mT, meT, G, *, ignore_model_err, wt_thresh):
    """Glue of `_fused_call_fullmask_dimprior` (ops/fused.py:1742-1815)
    around the two kernels; returns (pdf, lmap, levid), pdf in the
    exp(lnl - levid) scale."""
    F = d.shape[1]
    a1 = 0.5 * F - 1.0
    below, above = _fm.chi2_brackets(d, de, mT, meT, c0=2.0 * a1,
                                     ignore_model_err=ignore_model_err)
    lmap, shift = lmap_and_shift(below, above, F)
    # w = exp(lnl - lmap), so the cut lnl > ln(wt_thresh) + lmap is
    # w > exp(ln(wt_thresh)), computed as the JAX kernel does.
    wthr = (None if wt_thresh is None
            else float(np.exp(np.log(wt_thresh))))
    # The kernels mask the ragged model edge themselves: no sentinel
    # models, so nothing to subtract from s (ops/fused.py:1798-1808).
    pdf, s = _fm.chi2_stack(d, de, mT, meT, G, shift, a1=a1,
                            wthr=wthr, ignore_model_err=ignore_model_err)
    pos = s > 0
    levid = torch.where(pos, torch.log(torch.clamp_min(s, 1e-30)) + lmap,
                        -torch.inf)
    pdf = torch.where(pos[:, None], pdf * torch.exp(lmap - levid)[:, None],
                      0.0)
    return pdf, lmap, levid


def _plain_composition(d, de, dm, m, me, mm, G, *, dim_prior,
                       ignore_model_err, free_scale, wt_thresh, cdf_thresh):
    """logprob -> lmap / logsumexp -> exp -> threshold -> kde_stack."""
    res = _like.logprob(d, de, dm, m, me, mm, free_scale=free_scale,
                        ignore_model_err=ignore_model_err,
                        dim_prior=dim_prior)
    lnp = res.lnprob
    lmap = lnp.amax(dim=1)
    levid = torch.logsumexp(lnp, dim=1)
    wt = torch.exp(lnp - levid[:, None])
    return _kde.kde_stack(wt, G, wt_thresh, cdf_thresh), lmap, levid


def _is_full(mask):
    return bool((torch.as_tensor(mask) == 1).all())


def fused_fit_pdf(data, data_err, data_mask, models, models_err,
                  models_mask, G, *, dim_prior=True, ignore_model_err=False,
                  free_scale=False, wt_thresh=1e-3, cdf_thresh=None,
                  full_mask=None):
    """Fused fit -> PDF for one object batch.

    Takes the `ops.logprob` inputs plus a row-normalized kernel matrix
    `G` (Nmodel, Ngrid), as tensors on one device (or host arrays, which
    go to the models' device).  Returns (pdf, lmap, levid): unnormalized
    float32 PDFs (Nobj, Ngrid) in the exp(lnl - levid) scale and the GOF
    metrics; the caller normalizes PDFs.  `full_mask=None` reads both
    masks to decide.  Routing: see `fused_route`.
    """
    m = torch.as_tensor(models)
    dev = m.device
    f32 = dict(dtype=torch.float32, device=dev)
    d = torch.as_tensor(data, **f32)
    de = torch.as_tensor(data_err, **f32)
    if full_mask is None:
        full_mask = _is_full(data_mask) and _is_full(models_mask)
    route = fused_route(dev.type, full_mask=full_mask, dim_prior=dim_prior,
                        free_scale=free_scale, wt_thresh=wt_thresh,
                        cdf_thresh=cdf_thresh)
    m = m.to(torch.float32)
    me = torch.as_tensor(models_err, **f32)
    G = torch.as_tensor(G, **f32)
    if route == "plain":
        dm = torch.as_tensor(data_mask, **f32)
        mm = torch.as_tensor(models_mask, **f32)
        return _plain_composition(
            d, de, dm, m, me, mm, G, dim_prior=dim_prior,
            ignore_model_err=ignore_model_err, free_scale=free_scale,
            wt_thresh=wt_thresh, cdf_thresh=cdf_thresh)
    pdf, lmap, levid = _fullmask_dimprior(
        d.contiguous(), de.contiguous(), m.T.contiguous(),
        me.T.contiguous(), G.contiguous(),
        ignore_model_err=ignore_model_err, wt_thresh=wt_thresh)
    # Degenerate rows (every model at the -inf floor): zero PDF, -inf GOF.
    ok = lmap > _NEG_INF / 2
    pdf = torch.where(ok[:, None], pdf, 0.0)
    lmap = torch.where(ok, lmap, -torch.inf)
    levid = torch.where(ok, levid, -torch.inf)
    return pdf, lmap, levid
