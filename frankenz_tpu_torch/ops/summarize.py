"""
PDF summary statistics: point estimates, credible bounds, MC draws.

Port of `frankenz_tpu.ops.summarize` (reference `frankenz/pdf.py:855-1074`).
Everything is batched over objects: quantiles and the confidence / risk
lookups are one batched linear interpolation (`_interp`, the exact
`jnp.interp` rule written with `torch.searchsorted`), the risk map is one
(Nobj, Ngrid) @ (Ngrid, Ngrid) product in full float32.  `argmax` and
`argmin` take the first index on ties, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .kde import _input_device, fp32_matmul

__all__ = ["pdfs_resample", "pdfs_summarize", "PDFSummary", "PointEstimate",
           "SUMMARY_NCOLS", "loss_kernel_matrix", "summary_stream_step",
           "unpack_summary", "label_grid_of", "stream_summary_setup"]


class PointEstimate(NamedTuple):
    """A point estimator with its quality metrics, each of shape (Nobj,)."""

    point: torch.Tensor
    std: torch.Tensor
    conf: torch.Tensor
    risk: torch.Tensor


class PDFSummary(NamedTuple):
    """Full output of `pdfs_summarize` (reference 6-tuple order,
    pdf.py:1070-1074)."""

    mean: PointEstimate
    median: PointEstimate
    mode: PointEstimate
    best: PointEstimate
    low95: torch.Tensor
    low68: torch.Tensor
    high68: torch.Tensor
    high95: torch.Tensor
    mc: torch.Tensor


def _interp(x, xp, fp, left=None, right=None):
    """Row-batched `jnp.interp(x, xp, fp, left, right)`.

    `x` is (N, Q); `xp` and `fp` are each (K,) or (N, K).  Same rule as
    JAX: i = clip(searchsorted(xp, x, right), 1, K-1), a zero-width
    interval takes fp[i-1], and x below xp[0] (above xp[-1]) takes `left`
    (`right`), the end values when None.
    """
    n, k = x.shape[0], xp.shape[-1]
    xp2 = xp.expand(n, k).contiguous()
    fp2 = fp.expand(n, k)
    i = torch.searchsorted(xp2, x.contiguous(), right=True).clamp(1, k - 1)
    xp_lo, xp_hi = xp2.gather(1, i - 1), xp2.gather(1, i)
    fp_lo, fp_hi = fp2.gather(1, i - 1), fp2.gather(1, i)
    dx = xp_hi - xp_lo
    delta = x - xp_lo
    eps = float(np.spacing(np.finfo(
        np.float64 if xp2.dtype == torch.float64 else np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp_lo,
                    fp_lo + (delta / torch.where(dx0, 1.0, dx))
                    * (fp_hi - fp_lo))
    f = torch.where(x < xp2[:, :1], fp2[:, :1] if left is None else left, f)
    return torch.where(x > xp2[:, -1:], fp2[:, -1:] if right is None
                       else right, f)


def pdfs_resample(pdfs, old_grid, new_grid, renormalize=True, left=0.0,
                  right=0.0):
    """Linearly resample PDFs onto a new grid (pdf.py:855-896); points
    outside `old_grid` take `left` / `right`.  Tensors stay on their
    device, host arrays go where `ops.kde._input_device` puts them."""
    dev = _input_device(pdfs, old_grid, new_grid)
    pdfs = torch.atleast_2d(torch.as_tensor(pdfs, device=dev))
    old_grid = torch.as_tensor(old_grid, device=dev)
    new_grid = torch.as_tensor(new_grid, device=dev)
    dt = torch.promote_types(pdfs.dtype, old_grid.dtype)
    x = new_grid.to(dt).expand(pdfs.shape[0], -1)
    new_pdfs = _interp(x, old_grid.to(dt), pdfs.to(dt), left=left,
                       right=right)
    if renormalize:
        new_pdfs = new_pdfs / new_pdfs.sum(dim=1, keepdim=True)
    return new_pdfs


def _default_photoz_kern_grid(pgrid):
    """(z_true - z_guess)/((1+z_true)*0.15) (pdf.py:1004-1011)."""
    ptrue = pgrid[:, None]
    pguess = pgrid[None, :]
    return (ptrue - pguess) / ((1.0 + ptrue) * 0.15)


def _loss_kernel(pkern, pkern_grid):
    """Evaluate the loss kernel over the grid (pdf.py:1012-1023)."""
    if pkern == "tophat":
        return (torch.square(pkern_grid) < 1.0).to(pkern_grid.dtype)
    if pkern == "gaussian":
        return torch.exp(-0.5 * torch.square(pkern_grid))
    if pkern == "lorentz":
        return 1.0 / (1.0 + torch.square(pkern_grid))
    if callable(pkern):
        return pkern(pkern_grid)
    raise ValueError("unknown loss kernel: {!r}".format(pkern))


def loss_kernel_matrix(pgrid, pkern="lorentz", pkern_grid=None):
    """(Ngrid, Ngrid) complementary loss matrix 1 - kernel; the risk map
    is ``pdfs @ loss_kernel_matrix(...)`` (pdf.py:1024-1025)."""
    pgrid = torch.as_tensor(pgrid)
    if pkern_grid is None:
        pkern_grid = _default_photoz_kern_grid(pgrid)
    return 1.0 - _loss_kernel(pkern, torch.as_tensor(pkern_grid,
                                                     device=pgrid.device))


def pdfs_summarize(pdfs, pgrid, renormalize=True, generator=None, u=None,
                   pkern="lorentz", pkern_grid=None, wconf_func=None):
    """Point estimators + quality metrics for a batch of PDFs
    (reference `pdf.py:899-1074`).

    The Monte Carlo draw takes its uniforms from `u` (Nobj,) when given,
    else from ``torch.rand`` with `generator` (a `torch.Generator`; the
    default generator when None).  Mean (L2), median (L1), mode (L0) and
    "best" (least expected loss under `pkern`) each carry std, conf
    (mass within +/- wconf_func(point), default (1+point)*0.03) and risk.
    """
    pdfs = torch.atleast_2d(torch.as_tensor(pdfs))
    pgrid = torch.as_tensor(pgrid, dtype=pdfs.dtype, device=pdfs.device)
    if u is None:
        u = torch.rand(pdfs.shape[0], generator=generator, dtype=pdfs.dtype,
                       device=pdfs.device)
    u = torch.as_tensor(u, dtype=pdfs.dtype, device=pdfs.device)
    kern_c = loss_kernel_matrix(pgrid, pkern, pkern_grid).to(pdfs.dtype)
    return _summarize_core(pdfs, pgrid, kern_c, u, renormalize, wconf_func)


def _summarize_core(pdfs, pgrid, kern_c, u, renormalize=True,
                    wconf_func=None):
    """`pdfs_summarize` body with the MC uniforms `u` and the
    complementary loss matrix `kern_c` passed explicitly."""
    if renormalize:
        pdfs = pdfs / pdfs.sum(dim=1, keepdim=True)

    pmean = fp32_matmul(pdfs, pgrid)
    pmode = pgrid[torch.argmax(pdfs, dim=1)]
    cdfs = torch.cumsum(pdfs, dim=1)

    qs = torch.tensor([0.025, 0.16, 0.5, 0.84, 0.975], dtype=pdfs.dtype,
                      device=pdfs.device)
    qx = torch.cat([qs.expand(pdfs.shape[0], 5), u[:, None]], dim=1)
    qvals = _interp(qx, cdfs, pgrid)
    plow2, plow1, pmed, phigh1, phigh2, pmc = qvals.unbind(dim=1)

    prisk = fp32_matmul(pdfs, kern_c)
    pbest = pgrid[torch.argmin(prisk, dim=1)]

    if wconf_func is None:
        def wconf_func(point):
            return (1.0 + point) * 0.03

    def estimate(point):
        sqdev = torch.square(pgrid[None, :] - point[:, None])
        std = torch.sqrt(torch.sum(sqdev * pdfs, dim=1))
        width = wconf_func(point)
        bounds = torch.stack([point - width, point + width], dim=1)
        lohi = _interp(bounds, pgrid, cdfs)
        risk = _interp(point[:, None], pgrid, prisk)[:, 0]
        return PointEstimate(point, std, lohi[:, 1] - lohi[:, 0], risk)

    return PDFSummary(estimate(pmean), estimate(pmed), estimate(pmode),
                      estimate(pbest), plow2, plow1, phigh1, phigh2, pmc)


# Packed-column layout of the streaming summary: 4 point estimators x
# (point, std, conf, risk), then the 4 credible bounds and the MC draw.
SUMMARY_NCOLS = 21


def _pack_summary(s):
    """PDFSummary -> (Nobj, SUMMARY_NCOLS) matrix (see SUMMARY_NCOLS)."""
    cols = []
    for est in (s.mean, s.median, s.mode, s.best):
        cols += [est.point, est.std, est.conf, est.risk]
    cols += [s.low95, s.low68, s.high68, s.high95, s.mc]
    return torch.stack(cols, dim=1)


def unpack_summary(cols):
    """(Nobj, SUMMARY_NCOLS) matrix -> PDFSummary (inverse of packing)."""
    ests = [PointEstimate(cols[:, 4 * i], cols[:, 4 * i + 1],
                          cols[:, 4 * i + 2], cols[:, 4 * i + 3])
            for i in range(4)]
    return PDFSummary(*ests, cols[:, 16], cols[:, 17], cols[:, 18],
                      cols[:, 19], cols[:, 20])


def label_grid_of(label_dict, label_grid):
    """The label grid a fit_predict call stacks PDFs on."""
    if label_dict is not None:
        return np.asarray(label_dict.grid)
    if label_grid is not None:
        return np.asarray(label_grid)
    raise ValueError("`label_dict` or `label_grid` must be specified.")


def stream_summary_setup(grid, pkern="lorentz", pkern_grid=None,
                         summary_seed=0, device=None):
    """Factory for the fitters' streaming-summary hook.

    Returns ``setup(ndata, batch_size) -> (post, SUMMARY_NCOLS)``, where
    ``post(pdf_batch, i0)`` summarizes one normalized PDF batch on its
    device.  The MC uniforms are drawn once as
    ``np.random.default_rng(summary_seed).random(npad)`` over the padded
    catalog (the JAX package draws the same values), and every batch
    slices its global rows, so results do not depend on batching.
    """
    grid_dev = torch.as_tensor(np.asarray(grid), dtype=torch.float32,
                               device=device)
    kern_c = loss_kernel_matrix(grid_dev, pkern, pkern_grid).to(
        torch.float32)

    def setup(ndata, batch_size):
        npad = -(-ndata // batch_size) * batch_size
        u_dev = torch.as_tensor(
            np.random.default_rng(summary_seed).random(npad),
            dtype=torch.float32, device=device)

        # A sharded fit (`mesh=`) sums batches on several devices: each
        # takes its own copy of the grid, kernel and uniforms.
        copies = {u_dev.device: (grid_dev, kern_c, u_dev)}

        def post(pdf_b, i0):
            dev = pdf_b.device
            if dev not in copies:
                copies[dev] = tuple(t.to(dev) for t in copies[u_dev.device])
            return summary_stream_step(pdf_b, *copies[dev], i0)

        return post, SUMMARY_NCOLS

    return setup


def summary_stream_step(pdfs, pgrid, kern_c, u_all, i0):
    """Summarize one batch `pdfs` (B, Ngrid) and return the packed
    (B, SUMMARY_NCOLS) columns; `u_all` holds the whole catalog's MC
    uniforms and `i0` is the batch's first global row."""
    dt = torch.promote_types(pdfs.dtype, pgrid.dtype)
    u = u_all[i0:i0 + pdfs.shape[0]]
    return _pack_summary(_summarize_core(pdfs.to(dt), pgrid.to(dt),
                                         kern_c.to(dt), u.to(dt)))
