"""Plain reference of `BruteForce.fit_predict(..., return_gof=True)`.

The semantics of the upstream fitter (frankenz `bruteforce.py` and
`pdf.py`), written out again in plain torch from the configuration and the
benchmark's own inputs, and importing nothing of the program:

* the likelihood (`pdf.py:27-100`, `_loglike`): per pair the combined
  mask, the variance ``sigma_d^2 + sigma_m^2``, chi^2 over the observed
  bands and the chi^2-distribution log density with ``Ndim`` degrees of
  freedom (the dim prior); no common band: ``-inf``;
* free scale (`pdf.py:103-235`, `_loglike_s`): the ML scale, refined with
  the variance ``sigma_d^2 + (s sigma_m)^2`` until each object's largest
  change of the Normal log-likelihood over all models is at most `ltol`
  (at most 100 sweeps), chi^2 in the residual form, ``sum log var`` over
  every band; then the dim prior with ``Ndim - 1`` degrees of freedom
  (``Ndim < 2``: ``-inf``);
* lmap (the largest log-posterior), levid (its log-sum-exp), the weights
  ``exp(lnp - levid)`` kept where above ``wt_thresh`` times their largest
  (`pdf.py:508-516`);
* the dictionary KDE (`pdf.py:529-622`, 778-852): each model's label and
  error put on the grid and the sigma dictionary, a Gaussian evaluated at
  the grid offsets within ``ceil(sigma * trunc / delta)`` cells,
  renormalized over its window; the PDF the kept weights' sum of those
  rows, normalized to 1 (an all-zero row stays zero).

`Arith` sets the arithmetic: float64 for the reference, and the control,
the same code in TF32 (every result rounded to 10 mantissa bits, the
matrix product's operands too, accumulating in float32).  Rows run in
blocks so that the (rows, models) arrays fit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_LOG_2PI = math.log(2.0 * math.pi)
_SQRT_2PI = math.sqrt(2.0 * math.pi)


def round_tf32(x):
    """float32 `x` rounded to TF32 (10 explicit mantissa bits, nearest,
    ties to even)."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + (0xFFF + ((b >> 13) & 1))) & -0x2000
    return b.view(torch.float32)


class Arith:
    """The arithmetic of one side: `dtype` and `r`, applied to every
    result (the identity but in TF32)."""

    def __init__(self, name):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown arithmetic {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32
        self.r = (lambda x: x) if name == "float64" else round_tf32

    def matmul(self, a, b):
        r = self.r
        return r(r(a) @ r(b))


def kernel_matrix(labels, label_errs, grid, sigmas, sigma_trunc, device,
                  arith):
    """(Nmodel, Ngrid) dictionary kernel rows, each summing to 1."""
    r = arith.r
    delta = grid[1] - grid[0]
    dsig = sigmas[1] - sigmas[0]
    width = np.minimum(np.ceil(sigmas * sigma_trunc / delta).astype(np.int64),
                       len(grid))
    pos = np.round((np.asarray(labels) - grid[0]) / delta).astype(np.int64)
    sig = np.clip(np.round((np.asarray(label_errs) - sigmas[0]) / dsig)
                  .astype(np.int64), 0, len(sigmas) - 1)
    dt = arith.dtype
    off = (torch.arange(len(grid), device=device)[None, :]
           - torch.as_tensor(pos, device=device)[:, None])
    s = torch.as_tensor(sigmas[sig], dtype=dt, device=device)[:, None]
    w = torch.as_tensor(width[sig], device=device)[:, None]
    x = r(r(off.to(dt) * delta) / s)
    vals = r(r(torch.exp(r(-0.5 * r(x * x)))) / r(_SQRT_2PI * s))
    vals = torch.where(off.abs() <= w, vals, 0.0)
    norm = r(vals.sum(dim=1, keepdim=True))
    return torch.where(norm > 0, r(vals / torch.where(norm > 0, norm, 1.0)),
                       0.0)


def _chi2_logpdf(chi2, dof, arith):
    """log of the chi^2 density with `dof` degrees of freedom at `chi2`:
    ``xlogy(a - 1, max(chi2, 1e-30)) - chi2 / 2 - lgamma(a) - a log 2``,
    a = dof/2; dof <= 0: -inf.  The floor is the fitter's (its fused
    route, frankenz_tpu ops/fused.py, documents it): with one degree of
    freedom the density is infinite at chi2 = 0, where a datum equals a
    model's flux to the last bit, and the floor keeps that pair's weight
    finite and dominant, so the PDF is the limit's (that model's kernel
    row).  Without it lmap and levid are +inf and every weight exp(inf -
    inf) is undefined."""
    r = arith.r
    a = 0.5 * dof
    safe = torch.clamp_min(a, 0.5)
    norm = torch.lgamma(safe) + safe * math.log(2.0)
    xl = r(torch.xlogy(a - 1.0, torch.clamp_min(chi2, 1e-30)))
    lnl = r(r(xl - r(0.5 * chi2)) - r(norm))
    return torch.where(dof > 0, lnl, -torch.inf)


def lnl_fixed(d, de, dm, m, me, mm, arith):
    """Fixed-scale log-likelihood with the dim prior, (B, M)."""
    r = arith.r
    chi2 = torch.zeros((d.shape[0], m.shape[0]), dtype=d.dtype,
                       device=d.device)
    ndim = torch.zeros_like(chi2)
    for k in range(d.shape[1]):
        mask = dm[:, k:k + 1] * mm[None, :, k]
        var = r(r(de[:, k:k + 1] ** 2) + r(me[None, :, k] ** 2))
        res = r(d[:, k:k + 1] - m[None, :, k])
        chi2 = r(chi2 + mask * r(r(res * res) / var))
        ndim = ndim + mask
    return _chi2_logpdf(chi2, ndim, arith)


def _free_sweep(d, de, dm, m, me, mm, ndim, scale, arith):
    """One sweep: the variance at `scale` (None: the unscaled one), the
    ML scale under it, chi^2 in the residual form and the Normal lnl."""
    r = arith.r
    z = torch.zeros((d.shape[0], m.shape[0]), dtype=d.dtype, device=d.device)
    inter, shape, big_a, logvar = z, z, z, z
    variances = []
    for k in range(d.shape[1]):
        sme = me[None, :, k] if scale is None else r(scale * me[None, :, k])
        var = r(r(de[:, k:k + 1] ** 2) + r(sme * sme))
        variances.append(var)
        miv = r(dm[:, k:k + 1] * mm[None, :, k] / var)
        mk, dk = m[None, :, k], d[:, k:k + 1]
        inter = r(inter + r(r(miv * mk) * dk))
        shape = r(shape + r(r(miv * mk) * mk))
        big_a = r(big_a + r(r(miv * dk) * dk))
        logvar = r(logvar + r(torch.log(var)))
    finfo = torch.finfo(d.dtype)
    new_scale = r(inter / torch.clamp_min(shape, finfo.tiny))
    chi2 = z
    for k, var in enumerate(variances):
        res = r(d[:, k:k + 1] - r(new_scale * m[None, :, k]))
        miv = r(dm[:, k:k + 1] * mm[None, :, k] / var)
        chi2 = r(chi2 + r(miv * r(res * res)))
    chi2 = torch.maximum(chi2, 16.0 * finfo.eps * big_a)
    lnl = r(-0.5 * chi2 - r(0.5 * r(r(ndim * _LOG_2PI) + logvar)))
    return new_scale, chi2, lnl, big_a


def lnl_free(d, de, dm, m, me, mm, arith, ltol, max_iter=100):
    """Free-scale log-likelihood with model errors and the dim prior,
    (B, M), and the sweeps each object ran (the first included).  Each
    sweep after the first runs on the objects not yet converged."""
    ndim = dm @ mm.T
    scale, chi2, lnl, _ = _free_sweep(d, de, dm, m, me, mm, ndim, None,
                                      arith)
    sweeps = torch.ones(d.shape[0], dtype=torch.int64, device=d.device)
    live = torch.arange(d.shape[0], device=d.device)
    eps = torch.finfo(d.dtype).eps
    for _ in range(max_iter):
        if not len(live):
            break
        s_n, chi2_n, lnl_n, big_a = _free_sweep(
            d[live], de[live], dm[live], m, me, mm, ndim[live], scale[live],
            arith)
        lerr = (lnl_n - lnl[live]).abs().amax(dim=1)
        scale[live], chi2[live], lnl[live] = s_n, chi2_n, lnl_n
        sweeps[live] += 1
        live = live[lerr > torch.clamp_min(4.0 * eps * big_a.amax(dim=1),
                                           ltol)]
    lnp = _chi2_logpdf(chi2, ndim - 1.0, arith)
    return torch.where(ndim >= 2, lnp, -torch.inf), sweeps


class Reference:
    """The reference (or, with ``Arith("tf32")``, the control) of one
    deployment: `rows(data, data_err, data_mask)` gives the fitter's
    outputs for those rows, with what the roofline counts need."""

    def __init__(self, config, models, models_err, models_mask, labels,
                 label_errs, grid, sigmas, sigma_trunc, device,
                 arith=Arith("float64"), block=512):
        self.arith = arith
        self.device = torch.device(device)
        self.block = int(block)
        fit = config["fit"]
        lkw = fit.get("lprob_kwargs", {})
        if set(lkw) - {"free_scale", "ignore_model_err", "ltol"} or \
                lkw.get("ignore_model_err"):
            raise ValueError(f"the reference has the dim prior, and model "
                             f"errors under free scale; not {lkw}")
        self.free = bool(lkw.get("free_scale", False))
        self.ltol = float(lkw.get("ltol", 1e-4))
        self.wt_thresh = float(fit["wt_thresh"])
        self.log_thresh = math.log(self.wt_thresh)
        dt = arith.dtype
        self.m, self.me, self.mm = (
            torch.as_tensor(t, device=self.device).to(dt)
            for t in (models, models_err, models_mask))
        self.G = kernel_matrix(labels, label_errs, grid, sigmas,
                               sigma_trunc, self.device, arith)
        self.g_nnz = (self.G != 0).sum(dim=1).to(torch.float64)

    def rows(self, data, data_err, data_mask, flip_band=0.0):
        """Host arrays for the rows given: ``pdf`` (B, Ngrid) normalized,
        ``lmap``, ``levid``; the envelope of the normalized PDF over the
        pairs whose log-weight lies within `flip_band` nats of the cut
        (``pdf_lo``, ``pdf_hi``: either side of the cut may be right
        there); per row ``kept`` and ``kept_nnz`` (kept pairs, and their
        nonzero kernel entries) and ``sweeps``."""
        outs = [self._block(*(np.asarray(a[i:i + self.block])
                              for a in (data, data_err, data_mask)),
                            flip_band)
                for i in range(0, len(data), self.block)]
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def _block(self, d, de, dm, flip_band):
        a, dev, dt = self.arith, self.device, self.arith.dtype
        d, de, dm = (torch.as_tensor(x, device=dev).to(dt) for x in
                     (d, de, dm))
        if self.free:
            lnp, sweeps = lnl_free(d, de, dm, self.m, self.me, self.mm, a,
                                   self.ltol)
        else:
            lnp = lnl_fixed(d, de, dm, self.m, self.me, self.mm, a)
            sweeps = torch.zeros(d.shape[0], dtype=torch.int64, device=dev)
        r = a.r
        lmap = lnp.amax(dim=1)
        good = torch.isfinite(lmap)
        top = torch.where(good, lmap, 0.0)[:, None]
        levid = torch.where(
            good, r(lmap + r(torch.log(r(torch.exp(r(lnp - top)).sum(1))))),
            -torch.inf)
        lv = torch.where(good, levid, 0.0)[:, None]
        wt = torch.where(good[:, None], r(torch.exp(r(lnp - lv))), 0.0)
        wmax = wt.amax(dim=1, keepdim=True)
        keep = wt > r(self.wt_thresh * wmax)
        # Pairs near the cut, measured in log-weight against lmap.
        near = ((lnp - top - self.log_thresh).abs() <= flip_band) & \
            good[:, None]
        sure = keep & ~near
        pdf = a.matmul(torch.where(keep, wt, 0.0), self.G)
        lo = a.matmul(torch.where(sure, wt, 0.0), self.G)
        amb = a.matmul(torch.where(near, wt, 0.0), self.G)
        s_lo = lo.sum(1, keepdim=True)
        s_amb = amb.sum(1, keepdim=True)

        def norm(x, s):
            return torch.where(s > 0, r(x / torch.where(s > 0, s, 1.0)), 0.0)

        out = dict(pdf=norm(pdf, r(pdf.sum(1, keepdim=True))),
                   pdf_lo=norm(lo, s_lo + s_amb), pdf_hi=norm(lo + amb, s_lo),
                   lmap=lmap, levid=levid,
                   kept=keep.sum(1).to(torch.float64),
                   near=near.sum(1).to(torch.float64),
                   kept_nnz=(keep.to(torch.float64) @ self.g_nnz),
                   sweeps=sweeps)
        return {k: v.cpu().numpy() for k, v in out.items()}
