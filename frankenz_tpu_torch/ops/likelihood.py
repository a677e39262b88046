"""
Photometric log-likelihood, batched over objects.

Port of `frankenz_tpu.ops.likelihood` (reference `frankenz/pdf.py:27-411`)
as plain functions on tensors: shapes ``(Nobj, Nfilt) x (Nmodel, Nfilt)
-> (Nobj, Nmodel)``.  Math contract (<= 1e-6 relative to the reference in
float64):

* combined mask ``data_mask * models_mask``; total variance
  ``sigma_d^2 + sigma_m^2`` (``sigma_d^2`` alone with ``ignore_model_err``)
* ``dim_prior=True`` uses the chi^2-distribution logpdf with dof = Ndim
  (fixed scale) or Ndim - 1 (free scale); pairs without that many
  common bands get lnl = -inf
* free scale: the ML scale ``s = (sum m d / var) / (sum m^2 / var)``,
  with model errors kept refined by the frozen-numerator fixed point
  (variance ``sigma_d^2 + (s sigma_m)^2``) until each object's
  ``max |delta lnl|`` over the models is at most ``max(ltol, 4 eps
  max A)``; chi^2 in the residual form, floored at ``16 eps A``
* the Normal logpdf's ``sum(log tot_var)`` runs over *all* filters
* `loglike` treats non-finite / non-positive-error bands as masked

The model triplet may also be gathered per object, (Nobj, J, Nfilt):
object b is then fitted against its own J models, as the JAX package's
vmapped single-object call does (`_gathered_lprob_jit`, frankenz_tpu/
models/knn.py:76), with the single-object arithmetic (free scale never
takes the matmul branch).

Inputs are promoted to at least float32 and keep float64 when given it,
as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.special import gammaln as _sp_gammaln

from .kde import _input_device, fp32_matmul

__all__ = ["static_spec", "LoglikeResult", "LogprobResult", "loglike",
           "loglike_fixed", "loglike_free", "logprob", "clean_data"]

_LOG_2PI = 1.8378770664093453  # log(2*pi)
_LOG_2 = 0.6931471805599453  # log(2)
# Free-scale chi^2 floor, as a multiple of eps * A (A = sum mask d^2 /
# var): below it the residual form is rounding noise, and the dof = 1
# dim-prior log would turn that noise into whole nats.  The kernels
# floor identically (ops/likelihood.py:70 in the JAX package).
_CHI2_NOISE_MULT = 16.0


class LoglikeResult(NamedTuple):
    """Output of the likelihood functions: (Nobj, Nmodel) tensors."""

    lnlike: torch.Tensor
    ndim: torch.Tensor
    chi2: torch.Tensor
    scale: torch.Tensor | None = None
    scale_err: torch.Tensor | None = None


class LogprobResult(NamedTuple):
    """Output of `logprob` (reference pdf.py:404-411 tuple order)."""

    lnprior: torch.Tensor
    lnlike: torch.Tensor
    lnprob: torch.Tensor
    ndim: torch.Tensor
    chi2: torch.Tensor
    scale: torch.Tensor | None = None
    scale_err: torch.Tensor | None = None


def _f(x, device=None):
    """Tensor of at least float32 (float64 stays float64), on `device`,
    else on its own (a tensor), else on the card (`_input_device`)."""
    t = torch.as_tensor(x, device=_input_device(x, device=device))
    if t.dtype != torch.float64:
        t = t.to(torch.float32)
    return t


def _inputs(*xs):
    """The likelihood's six inputs (model triplet first) on one device,
    the first tensor's, else the card; the data triplet at least 2-D."""
    dev = _input_device(*xs)
    m, me, mm, d, de, dm = (_f(x, dev) for x in xs)
    return (m, me, mm, *_atleast_2d(d, de, dm))


def _atleast_2d(*tensors):
    return tuple(t if t.ndim == 2 else t[None, :] for t in tensors)


def _chi2_dim_logpdf(a, chi2, max_ndim):
    """logpdf of the chi^2 distribution with dof 2*a evaluated at chi2:
    ``xlogy(a - 1, chi2) - chi2/2 - gammaln(a) - a*log(2)``.

    2a takes integer-or-half-integer values in [-1, max_ndim], so the
    ``gammaln(a) + a*log2`` term is one table lookup per pair.
    """
    twoa = np.arange(-2, 2 * max_ndim + 1) * 0.5
    table = torch.as_tensor(_sp_gammaln(0.5 * twoa) + _LOG_2 * 0.5 * twoa,
                            dtype=chi2.dtype, device=chi2.device)
    idx = torch.round(4.0 * a + 2.0).to(torch.int64)
    norm = table[idx.clamp(0, table.shape[0] - 1)]
    return torch.xlogy(a - 1.0, chi2) - 0.5 * chi2 - norm


def _mcol(t, k):
    """Filter k of a model array: (1, Nmodel) of a shared (Nmodel,
    Nfilt) set, (Nobj, J) of a gathered (Nobj, J, Nfilt) one."""
    return t[..., k] if t.ndim == 3 else t[None, :, k]


def _ndim(dm, mm):
    """Common bands per pair (exact: 0/1 entries)."""
    if mm.ndim == 3:
        return (dm[:, None, :] * mm).sum(dim=-1)
    return dm @ mm.T


def _filter_reduce(d, de, dm, m, me, mm, *, ignore_model_err, need_logvar):
    """chi^2 (and optionally sum-log-variance) over the filter axis, one
    (Nobj, Nmodel) accumulator updated per filter: the (Nobj, Nmodel,
    Nfilt) cube is never built."""
    nobj, nmodel = d.shape[0], m.shape[-2]
    dt = torch.promote_types(d.dtype, m.dtype)
    chi2 = torch.zeros((nobj, nmodel), dtype=dt, device=d.device)
    logvar = torch.zeros_like(chi2) if need_logvar else None
    for k in range(d.shape[1]):
        dek = de[:, k:k + 1]
        mek = _mcol(me, k)
        mask = dm[:, k:k + 1] * _mcol(mm, k)
        if ignore_model_err:
            var = dek * dek + torch.zeros((1, nmodel), dtype=dt,
                                          device=d.device)
        else:
            var = dek * dek + mek * mek
        resid = d[:, k:k + 1] - _mcol(m, k)
        chi2 = chi2 + mask * resid * resid / var
        if need_logvar:
            logvar = logvar + torch.log(var)
    return chi2, logvar


def clean_data(data, data_err, data_mask):
    """Mask out non-finite / non-positive-error bands (pdf.py:310-311):
    bad bands get value 0, error 1, mask 0."""
    dev = _input_device(data, data_err, data_mask)
    d, de, dm = _f(data, dev), _f(data_err, dev), _f(data_mask, dev)
    ok = torch.isfinite(d) & torch.isfinite(de) & (de > 0.0)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    return (torch.where(ok, d, zero), torch.where(ok, de, zero + 1.0),
            torch.where(ok, dm, zero))


def _loglike_fixed(data, data_err, data_mask, models, models_err,
                   models_mask, *, clean, ignore_model_err, dim_prior):
    m, me, mm, d, de, dm = _inputs(models, models_err, models_mask, data,
                                   data_err, data_mask)
    if clean:
        d, de, dm = clean_data(d, de, dm)
    ndim = _ndim(dm, mm)
    chi2, logvar = _filter_reduce(d, de, dm, m, me, mm,
                                  ignore_model_err=ignore_model_err,
                                  need_logvar=not dim_prior)
    if dim_prior:
        # Zero-overlap pairs carry no evidence: -inf, not the reference's
        # NaN (a NaN would poison the caller's max / logsumexp).
        lnl = _chi2_dim_logpdf(0.5 * ndim, chi2, max_ndim=d.shape[1])
        lnl = torch.where(ndim > 0, lnl, -torch.inf)
    else:
        lnl = -0.5 * chi2 - 0.5 * (ndim * _LOG_2PI + logvar)
    return LoglikeResult(lnl, ndim, chi2)


def loglike_fixed(data, data_err, data_mask, models, models_err, models_mask,
                  *, ignore_model_err=False, dim_prior=True):
    """Fixed-scale log-likelihood (reference `pdf.py:27-100`).

    Data triplet (Nobj, Nfilt) or (Nfilt,), model triplet (Nmodel,
    Nfilt); returns a `LoglikeResult` of (Nobj, Nmodel) tensors on the
    first input tensor's device (the models' first), or on the card when
    every input is a host array.
    """
    return _loglike_fixed(data, data_err, data_mask, models, models_err,
                          models_mask, clean=False,
                          ignore_model_err=ignore_model_err,
                          dim_prior=dim_prior)


def _free_sweep(d, de, dm, m, me, mm, ndim, scale_prev, *,
                ignore_model_err):
    """One fixed-point sweep (`sweep` of ops/likelihood.py:316-371):
    var(scale_prev) -> scale, and chi^2 in the residual form with the
    same variance.  ``scale_prev=None`` is the initial variance
    ``sigma_d^2 + sigma_m^2``.  Returns (scale, shape, chi2, lnl, A)."""
    nobj, nfilt = d.shape
    nmodel = m.shape[-2]
    dt = torch.promote_types(d.dtype, m.dtype)
    zeros = torch.zeros((nobj, nmodel), dtype=dt, device=d.device)

    def var_k(k):
        dek2 = (de[:, k] * de[:, k])[:, None]
        if ignore_model_err:
            return dek2 + torch.zeros((1, nmodel), dtype=dt, device=d.device)
        mek = _mcol(me, k)
        if scale_prev is None:
            return dek2 + mek * mek
        smek = scale_prev * mek
        return dek2 + smek * smek

    inter, shape, A, logvar = zeros, zeros, zeros, zeros
    for k in range(nfilt):
        var = var_k(k)
        iv = 1.0 / var
        mask = dm[:, k:k + 1] * _mcol(mm, k)
        mk = _mcol(m, k)
        dk = d[:, k:k + 1]
        miv = mask * iv
        inter = inter + miv * mk * dk
        shape = shape + miv * mk * mk
        A = A + miv * dk * dk
        logvar = logvar + torch.log(var)
    finfo = torch.finfo(dt)
    scale = inter / torch.clamp_min(shape, finfo.tiny)
    chi2 = zeros
    for k in range(nfilt):
        iv = 1.0 / var_k(k)
        mask = dm[:, k:k + 1] * _mcol(mm, k)
        rk = d[:, k:k + 1] - scale * _mcol(m, k)
        chi2 = chi2 + (mask * iv) * rk * rk
    chi2 = torch.maximum(chi2, _CHI2_NOISE_MULT * finfo.eps * A)
    lnl = -0.5 * chi2 - 0.5 * (ndim * _LOG_2PI + logvar)
    return scale, shape, chi2, lnl, A


def _loglike_free(data, data_err, data_mask, models, models_err, models_mask,
                  *, clean, ignore_model_err, dim_prior, ltol, return_scale,
                  max_iter):
    """`_loglike_free_jit` (frankenz_tpu/ops/likelihood.py:223-422), both
    branches: the matmul one for datum-only variance (8 objects or
    more) and the general fixed-point one."""
    m, me, mm, d, de, dm = _inputs(models, models_err, models_mask, data,
                                   data_err, data_mask)
    if clean:
        d, de, dm = clean_data(d, de, dm)
    dt = torch.promote_types(d.dtype, m.dtype)
    d, de, dm, m, me, mm = (t.to(dt) for t in (d, de, dm, m, me, mm))
    nobj, nfilt = d.shape
    finfo = torch.finfo(dt)
    ndim = _ndim(dm, mm)

    if ignore_model_err and nobj >= 8 and m.ndim == 2:
        # Datum-only variance: the filter sums factor into products (full
        # float32 on the card: `fp32_matmul` refuses TF32).
        inv_var = dm / (de * de)
        inter = fp32_matmul(d * inv_var, (mm * m).T)
        shape = fp32_matmul(inv_var, (mm * m * m).T)
        A = fp32_matmul(d * d * inv_var, mm.T)
        scale = inter / torch.clamp_min(shape, finfo.tiny)
        # Residual form (pdf.py:188-189), not the cancelling A - inter s.
        chi2 = torch.zeros_like(inter)
        for k in range(nfilt):
            rk = d[:, k:k + 1] - scale * m[None, :, k]
            chi2 = chi2 + (inv_var[:, k:k + 1] * mm[None, :, k]) * rk * rk
        chi2 = torch.maximum(chi2, _CHI2_NOISE_MULT * finfo.eps * A)
        logvar = torch.log(de * de).sum(dim=1, keepdim=True)
        lnl = -0.5 * chi2 - 0.5 * (ndim * _LOG_2PI + logvar)
    else:
        scale, shape, chi2, lnl, _ = _free_sweep(
            d, de, dm, m, me, mm, ndim, None,
            ignore_model_err=ignore_model_err)
        done = torch.zeros(nobj, dtype=torch.bool, device=d.device)
        it = 0
        # Per-object convergence over every model (pdf.py:219-220), with
        # the roundoff floor 4 eps max A: a tighter ltol is below the
        # float32 noise of lnl and would never be met.
        while not ignore_model_err and it < max_iter and not bool(done.all()):
            scale_n, shape_n, chi2_n, lnl_n, A_n = _free_sweep(
                d, de, dm, m, me, mm, ndim, scale,
                ignore_model_err=ignore_model_err)
            lerr = (lnl_n - lnl).abs().amax(dim=1)
            floor = 4.0 * finfo.eps * A_n.amax(dim=1)
            keep = done[:, None]
            lnl = torch.where(keep, lnl, lnl_n)
            scale = torch.where(keep, scale, scale_n)
            chi2 = torch.where(keep, chi2, chi2_n)
            shape = torch.where(keep, shape, shape_n)
            done = done | (lerr <= torch.clamp_min(floor, ltol))
            it += 1
    if dim_prior:
        # dof = Ndim - 1 needs Ndim >= 2.
        lnl = _chi2_dim_logpdf(0.5 * (ndim - 1.0),
                               torch.clamp_min(chi2, 1e-30), max_ndim=nfilt)
        lnl = torch.where(ndim >= 2, lnl, -torch.inf)
    else:
        # Zero overlap: the ML scale is 0/0 (reference NaN): no evidence.
        lnl = torch.where(ndim > 0, lnl, -torch.inf)
    if return_scale:
        return LoglikeResult(lnl, ndim, chi2, scale,
                             torch.sqrt(1.0 / shape))
    return LoglikeResult(lnl, ndim, chi2)


def loglike_free(data, data_err, data_mask, models, models_err, models_mask,
                 *, ignore_model_err=False, dim_prior=True, ltol=1e-3,
                 return_scale=False, max_iter=100):
    """Free-scale log-likelihood: models rescaled by the ML factor
    (reference `pdf.py:103-235`, `_loglike_s`), the fixed point capped
    at `max_iter` sweeps.  Returns a `LoglikeResult` with `scale` and
    `scale_err` (``sqrt(1 / shape)``) when ``return_scale``."""
    return _loglike_free(data, data_err, data_mask, models, models_err,
                         models_mask, clean=False,
                         ignore_model_err=ignore_model_err,
                         dim_prior=dim_prior, ltol=ltol,
                         return_scale=return_scale, max_iter=max_iter)


def loglike(data, data_err, data_mask, models, models_err, models_mask,
            free_scale=False, ignore_model_err=False, dim_prior=True,
            ltol=1e-4, return_scale=False, **kwargs):
    """Dispatching wrapper with input sanitization (pdf.py:238-323).  As
    in the JAX package, `ltol` defaults to the reference's 1e-4 here and
    other keywords (``max_iter`` among them) are ignored."""
    if free_scale:
        return _loglike_free(data, data_err, data_mask, models, models_err,
                             models_mask, clean=True,
                             ignore_model_err=ignore_model_err,
                             dim_prior=dim_prior, ltol=ltol,
                             return_scale=return_scale, max_iter=100)
    return _loglike_fixed(data, data_err, data_mask, models, models_err,
                          models_mask, clean=True,
                          ignore_model_err=ignore_model_err,
                          dim_prior=dim_prior)


def static_spec(func, args=None, kwargs=None):
    """Hashable (func-or-None, args, sorted-kwargs-items) key; the default
    `logprob` canonicalizes to None."""
    return (None if func is None or func is logprob else func,
            tuple(args or ()),
            tuple(sorted((kwargs or {}).items())))


def logprob(data, data_err, data_mask, models, models_err, models_mask,
            free_scale=False, ignore_model_err=False, dim_prior=True,
            ltol=1e-4, return_scale=False, **kwargs):
    """Flat-prior log-posterior, the fitters' default `lprob_func`
    (reference `pdf.py:326-411`): lnprior is zero, lnprob is lnlike."""
    res = loglike(data, data_err, data_mask, models, models_err, models_mask,
                  free_scale=free_scale, ignore_model_err=ignore_model_err,
                  dim_prior=dim_prior, ltol=ltol, return_scale=return_scale)
    lnprior = torch.zeros_like(res.lnlike)
    return LogprobResult(lnprior, res.lnlike, res.lnlike, res.ndim, res.chi2,
                         res.scale, res.scale_err)
