"""
Weighted kernel density estimation of label PDFs on a fixed grid.

Port of `frankenz_tpu.ops.kde` (reference `frankenz/pdf.py:414-852`).
For a fixed set of label positions and widths the KDE stack is a linear
map of the weights,

    pdfs (Nobj, Ngrid) = weights (Nobj, Nmodel) @ G (Nmodel, Ngrid),

where row j of ``G`` is model j's truncated, window-renormalized kernel.
Reference-parity details (window truncation with int() bounds,
renormalization over the retained window, ``wt > wt_thresh * max``
thresholding, the CDF rule's drop-the-largest quirk, `PDFDict.fit`
rounding) follow the JAX module line for line.

Every stack product runs in full float32: TF32 keeps ~3 decimal digits,
far outside the PDF parity contract.  The gathered (per-object label
subset) variants are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["norm_rows", "gaussian", "PDFDict", "kernel_matrix",
           "kernel_matrix_dict", "threshold_weights", "kde_stack",
           "resolve_kde_opts"]

_SQRT_2PI = 2.5066282746310002


def resolve_kde_opts(kde_args=None, kde_kwargs=None, wt_thresh=1e-3,
                     cdf_thresh=2e-4):
    """Resolve the reference's `kde_args`/`kde_kwargs` forwarding into
    ``(dx, sig_thresh, wt_thresh, cdf_thresh)`` (bruteforce.py:363-369).
    At most one positional kde_arg (dx) is accepted, as in the reference
    call ``gauss_kde(y, y_std, x, y_wt=wt, *kde_args)``."""
    args = tuple(kde_args or ())
    if len(args) > 1:
        raise TypeError(
            "kde_args accepts at most one positional value (dx): the "
            "reference call gauss_kde(y, y_std, x, y_wt=wt, *kde_args) "
            "raises on more (collision with y_wt). Pass sig_thresh / "
            "wt_thresh / cdf_thresh via kde_kwargs.")
    kw = dict(kde_kwargs or {})
    dx = args[0] if args else kw.get("dx")
    sig_thresh = float(kw.get("sig_thresh", 5.0))
    wt_thresh = kw.get("wt_thresh", wt_thresh)
    cdf_thresh = kw.get("cdf_thresh", cdf_thresh)
    return dx, sig_thresh, wt_thresh, cdf_thresh


def fp32_matmul(a, b):
    """``a @ b`` that refuses to run in TF32 on the card.

    PDF cells and point estimates carry the float32 parity contract;
    TF32 (``torch.backends.cuda.matmul.allow_tf32``, or a float32 matmul
    precision below "highest") would silently round the inputs to 10
    mantissa bits, so it is an error rather than a slower answer.
    """
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "TF32 matmuls are enabled; the PDF stack and summary products "
            "need full float32 (set torch.backends.cuda.matmul.allow_tf32 "
            "= False and torch.set_float32_matmul_precision('highest'))")
    return a @ b


def norm_rows(pdf):
    """Normalize PDF rows to sum 1; all-zero rows stay zero."""
    norm = pdf.sum(dim=1, keepdim=True)
    pos = norm > 0
    return torch.where(pos, pdf / torch.where(pos, norm, 1.0), 0.0)


def gaussian(mu, std, x):
    """Gaussian PDF N(x | mu, std) on grid `x` (pdf.py:414-425)."""
    mu, std, x = (torch.as_tensor(v) for v in (mu, std, x))
    dif = x - mu
    return torch.exp(-0.5 * torch.square(dif / std)) / (_SQRT_2PI * std)


class PDFDict:
    """Discretized grid + Gaussian kernel dictionary (pdf.py:778-852).

    Host-side NumPy, as in the JAX package: kernels are evaluated at
    integer cell offsets, half-widths are truncated at `sigma_trunc`
    sigmas and capped at Ngrid.
    """

    def __init__(self, pdf_grid, sigma_grid, sigma_trunc=5.0):
        pdf_grid = np.asarray(pdf_grid, dtype=np.float64)
        sigma_grid = np.asarray(sigma_grid, dtype=np.float64)
        self.Ngrid = len(pdf_grid)
        self.min, self.max = pdf_grid.min(), pdf_grid.max()
        self.delta = pdf_grid[1] - pdf_grid[0]
        self.grid = pdf_grid

        self.Ndict = len(sigma_grid)
        self.sigma_grid = sigma_grid
        self.dsigma = sigma_grid[1] - sigma_grid[0]
        self.sigma_trunc = float(sigma_trunc)
        self.sigma_width = np.minimum(
            np.asarray(np.ceil(sigma_grid * sigma_trunc / self.delta),
                       dtype=np.int64),
            self.Ngrid)
        self.sigma_dict = [
            np.exp(-0.5 * ((np.arange(-w, w + 1) * self.delta) / s) ** 2)
            / (_SQRT_2PI * s)
            for s, w in zip(sigma_grid, self.sigma_width)
        ]
        self.sigma_dict_cdf = [np.cumsum(p) for p in self.sigma_dict]
        wmax = int(self.sigma_width.max())
        self.max_width = wmax
        table = np.zeros((self.Ndict, 2 * wmax + 1), dtype=np.float64)
        for i, (k, w) in enumerate(zip(self.sigma_dict, self.sigma_width)):
            table[i, wmax - w:wmax + w + 1] = k
        self.kernel_table = table

    def fit(self, X, Xe):
        """Quantize (mean, sigma) pairs onto the dictionary (pdf.py:821-852).

        Returns int32 NumPy arrays (X_idx, Xe_idx); X_idx is not clamped
        to the grid (as in the reference), Xe_idx is clamped to
        [0, Ndict-1].
        """
        X = np.asarray(X)
        Xe = np.asarray(Xe)
        x_idx = np.round((X - self.grid[0]) / self.delta).astype(np.int32)
        e_idx = np.round(
            (Xe - self.sigma_grid[0]) / self.dsigma).astype(np.int32)
        return x_idx, np.clip(e_idx, 0, self.Ndict - 1)


def _renorm(vals):
    norm = vals.sum(dim=-1, keepdim=True)
    pos = norm > 0.0
    return torch.where(pos, vals / torch.where(pos, norm, 1.0), 0.0)


def kernel_matrix(y, y_std, grid, dx=None, sig_thresh=5.0, device=None):
    """Row-normalized truncated-Gaussian kernel matrix G (Ny, Ngrid).

    Row j is the kernel `gauss_kde` (pdf.py:444-526) stacks for label j:
    evaluated on the grid, truncated at int()-discretized
    +/- sig_thresh*sigma bounds, renormalized over the retained window
    (zero row if the window sum vanishes).
    """
    grid = torch.as_tensor(grid, device=device)
    y = torch.as_tensor(y, device=grid.device)
    y_std = torch.as_tensor(y_std, device=grid.device)
    if dx is None:
        dx = grid[1] - grid[0]
    nx = grid.shape[0]
    centers = torch.trunc((y - grid[0]) / dx).to(torch.int32)
    offsets = torch.trunc(sig_thresh * y_std / dx).to(torch.int32)
    uppers = torch.where(centers + offsets > nx, nx, centers + offsets)
    lowers = torch.where(centers - offsets < 0, 0, centers - offsets)
    cols = torch.arange(nx, dtype=torch.int32, device=grid.device)
    in_win = (cols[None, :] >= lowers[:, None]) & (cols[None, :]
                                                   < uppers[:, None])
    vals = gaussian(y[:, None], y_std[:, None], grid[None, :]) * in_win
    return _renorm(vals)


def kernel_matrix_dict(pdfdict, y_idx, y_sig_idx, device=None):
    """Row-normalized kernel matrix from a `PDFDict` (Ny, Ngrid), float64.

    Row j is the edge-renormalized contribution `gauss_kde_dict`
    (pdf.py:529-622) stacks for dictionary element (y_idx[j],
    y_sig_idx[j]), evaluated arithmetically at each grid offset.
    """
    y_idx = torch.as_tensor(np.asarray(y_idx), dtype=torch.int64,
                            device=device)
    y_sig_idx = torch.as_tensor(np.asarray(y_sig_idx), dtype=torch.int64,
                                device=device)
    sigmas = torch.as_tensor(pdfdict.sigma_grid, device=y_idx.device)
    widths = torch.as_tensor(pdfdict.sigma_width, device=y_idx.device)
    cols = torch.arange(pdfdict.Ngrid, device=y_idx.device)
    off = cols[None, :] - y_idx[:, None]
    in_win = off.abs() <= widths[y_sig_idx][:, None]
    s = sigmas[y_sig_idx][:, None]
    x = off.to(s.dtype) * pdfdict.delta / s
    vals = torch.exp(-0.5 * x * x) / (_SQRT_2PI * s) * in_win
    return _renorm(vals)


def _threshold_rel(wts, wt_thresh):
    cut = wt_thresh * wts.amax(dim=-1, keepdim=True)
    return torch.where(wts > cut, wts, 0.0)


def _threshold_cdf(wts, cdf_thresh):
    # Ascending sort; the cumulative mass of the largest weight is
    # exactly 1, so the reference rule always drops it (kept quirk).
    sorted_wts, order = torch.sort(wts, dim=-1, stable=True)
    cdf = torch.cumsum(sorted_wts, dim=-1)
    cdf = cdf / cdf[..., -1:]
    keep_sorted = cdf <= (1.0 - cdf_thresh)
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, wts, 0.0)


def threshold_weights(wts, wt_thresh=1e-3, cdf_thresh=2e-4):
    """Zero out negligible weights, batched over objects (pdf.py:508-516).

    With `wt_thresh` set keeps ``wt > wt_thresh * max(wt)``; with
    ``wt_thresh=None`` applies the CDF rule, drop-the-largest quirk
    included; with both None keeps everything.
    """
    wts = torch.as_tensor(wts)
    if wt_thresh is None and cdf_thresh is None:
        return wts
    if wt_thresh is not None:
        return _threshold_rel(wts, wt_thresh)
    return _threshold_cdf(wts, cdf_thresh)


def kde_stack(weights, G, wt_thresh=1e-3, cdf_thresh=2e-4):
    """Stack thresholded weights through a kernel matrix: (Nobj, Ngrid),
    not normalized (the fitters normalize per object)."""
    wts = threshold_weights(weights, wt_thresh, cdf_thresh)
    return fp32_matmul(wts, G.to(wts.dtype))
