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

The gathered variants give every object its own (J,) label subset:
its kernel rows are built on the fly and contracted at once,
``einsum('bj,bjg->bg')``, in object chunks that keep the (B, J, Ngrid)
temporary under `GATHER_ELEMS` elements (rows are independent, so the
chunking changes no result).

Every stack product runs in full float32: TF32 keeps ~3 decimal digits,
far outside the PDF parity contract.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["norm_rows", "gaussian", "gaussian_bin", "PDFDict",
           "kernel_matrix", "kernel_matrix_dict", "threshold_weights",
           "kde_stack", "kde_stack_gathered", "kde_stack_gathered_dict",
           "pack_label_spec", "gauss_kde", "gauss_kde_dict",
           "resolve_kde_opts", "GATHER_ELEMS"]

# Elements of one chunk's (B, J, Ngrid) kernel rows in the gathered
# stacks (256 MB in float32).
GATHER_ELEMS = 1 << 26

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


def gaussian_bin(mu, std, bins):
    """Gaussian PDF integrated over bins with edges `bins`
    (pdf.py:428-441); one shorter than `bins` on the last axis."""
    mu, std, bins = (torch.as_tensor(v) for v in (mu, std, bins))
    y = (bins - mu) / (math.sqrt(2.0) * std)
    cdf = 0.5 * (1.0 + torch.erf(y))
    return cdf[..., 1:] - cdf[..., :-1]


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


def _kernel_rows(y, y_std, grid, dx, sig_thresh):
    """Kernel rows over the grid for labels of any leading shape:
    (..., Ngrid)."""
    nx = grid.shape[0]
    centers = torch.trunc((y - grid[0]) / dx).to(torch.int32)
    offsets = torch.trunc(sig_thresh * y_std / dx).to(torch.int32)
    uppers = torch.where(centers + offsets > nx, nx, centers + offsets)
    lowers = torch.where(centers - offsets < 0, 0, centers - offsets)
    cols = torch.arange(nx, dtype=torch.int32, device=grid.device)
    in_win = (cols >= lowers[..., None]) & (cols < uppers[..., None])
    vals = gaussian(y[..., None], y_std[..., None], grid) * in_win
    return _renorm(vals)


def _input_device(*xs, device=None):
    """Where an `ops` function puts its inputs: `device` when named, else
    the first tensor's device, else the card (host arrays alone, as JAX
    runs on its default device).  Without a card that raises: nothing
    falls back to the CPU unless asked (``device="cpu"`` or CPU
    tensors)."""
    if device is not None:
        return torch.device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    if not torch.cuda.is_available():
        raise RuntimeError("host inputs go to the card ('cuda') unless a "
                           "device is named, and no CUDA device is "
                           "available: pass device='cpu' or CPU tensors")
    return torch.device("cuda")


def kernel_matrix(y, y_std, grid, dx=None, sig_thresh=5.0, device=None):
    """Row-normalized truncated-Gaussian kernel matrix G (Ny, Ngrid).

    Row j is the kernel `gauss_kde` (pdf.py:444-526) stacks for label j:
    evaluated on the grid, truncated at int()-discretized
    +/- sig_thresh*sigma bounds, renormalized over the retained window
    (zero row if the window sum vanishes).  On `device`, else on the
    inputs' (`grid` first), else on the card.
    """
    grid = torch.as_tensor(grid,
                           device=_input_device(grid, y, y_std, device=device))
    y = torch.as_tensor(y, device=grid.device)
    y_std = torch.as_tensor(y_std, device=grid.device)
    if dx is None:
        dx = grid[1] - grid[0]
    return _kernel_rows(y, y_std, grid, dx, sig_thresh)


def _dict_rows(sigmas, widths, delta, pos, sig, nx):
    """Dictionary kernel rows for positions / sigma indices of any
    leading shape: (..., nx)."""
    cols = torch.arange(nx, device=pos.device)
    off = cols - pos[..., None]
    in_win = off.abs() <= widths[sig][..., None]
    s = sigmas[sig][..., None]
    x = off.to(s.dtype) * delta / s
    vals = torch.exp(-0.5 * x * x) / (_SQRT_2PI * s) * in_win
    return _renorm(vals)


def kernel_matrix_dict(pdfdict, y_idx, y_sig_idx, device=None):
    """Row-normalized kernel matrix from a `PDFDict` (Ny, Ngrid), float64.

    Row j is the edge-renormalized contribution `gauss_kde_dict`
    (pdf.py:529-622) stacks for dictionary element (y_idx[j],
    y_sig_idx[j]), evaluated arithmetically at each grid offset.  On
    `device`, else on the indices', else on the card.
    """
    device = _input_device(y_idx, y_sig_idx, device=device)
    y_idx = _as(y_idx, device, torch.int64)
    y_sig_idx = _as(y_sig_idx, device, torch.int64)
    sigmas = torch.as_tensor(pdfdict.sigma_grid, device=y_idx.device)
    widths = torch.as_tensor(pdfdict.sigma_width, device=y_idx.device)
    return _dict_rows(sigmas, widths, pdfdict.delta, y_idx, y_sig_idx,
                      pdfdict.Ngrid)


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


def lnprob_pdf(lnprob, G, wt_thresh=1e-3, cdf_thresh=2e-4):
    """(Nobj, Nmodel) log-posteriors -> (pdf, lmap, levid): the max, the
    logsumexp, and the weights exp(lnprob - levid) thresholded and
    stacked through `G`.  The PDFs are not normalized.  The fitters'
    plain composition, on one device or one shard."""
    lmap = lnprob.amax(dim=1)
    levid = torch.logsumexp(lnprob, dim=1)
    pdf = kde_stack(torch.exp(lnprob - levid[:, None]), G, wt_thresh,
                    cdf_thresh)
    return pdf, lmap, levid



def _as(x, device=None, dtype=None):
    """`x` as a tensor (host arrays copied: they may be read-only)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _gathered_stack(rows_fn, nx, wts, *cols):
    """einsum('bj,bjg->bg', wts, rows_fn(*cols)) in full precision, in
    object chunks of at most `GATHER_ELEMS` kernel-row elements."""
    nobj, j = wts.shape
    step = max(1, GATHER_ELEMS // max(j * nx, 1))
    parts = []
    for i0 in range(0, nobj, step):
        sl = slice(i0, i0 + step)
        rows = rows_fn(*(c[sl] for c in cols))
        dt = torch.promote_types(wts.dtype, rows.dtype)
        parts.append(fp32_matmul(wts[sl, None, :].to(dt), rows.to(dt))[:, 0])
    if not parts:
        return wts.new_zeros((0, nx))
    return torch.cat(parts)


def _kde_stack_gathered(sigmas, widths, delta, pos, sig, wts, nx):
    """Gathered dictionary stack on prepared tensors (the counterpart of
    `_kde_stack_gathered_jit`, frankenz_tpu/ops/kde.py:356)."""
    return _gathered_stack(
        lambda p, s: _dict_rows(sigmas, widths, delta, p, s, nx), nx, wts,
        pos, sig)


def _kde_stack_gathered_grid(y, y_std, wts, grid, dx, sig_thresh):
    """Gathered grid stack on prepared tensors (`_kde_stack_gathered_
    grid_jit`, frankenz_tpu/ops/kde.py:375)."""
    return _gathered_stack(
        lambda a, b: _kernel_rows(a, b, grid, dx, sig_thresh),
        grid.shape[0], wts, y, y_std)


def kde_stack_gathered_dict(pdfdict, pos, sig, wts):
    """KDE stack where every object has its own label subset.

    ``pos``/``sig``/``wts`` have shape (Nobj, J): per-object dictionary
    positions, sigma indices and weights (invalid slots: weight 0).  Each
    object's J kernel rows are built as `kernel_matrix_dict` builds them
    and contracted at once.  Unnormalized, like `kde_stack`.
    """
    wts = _as(wts)
    dev = wts.device
    sigmas = _as(pdfdict.sigma_grid, dev)
    widths = _as(pdfdict.sigma_width, dev, torch.int64)
    return _kde_stack_gathered(sigmas, widths, pdfdict.delta,
                               _as(pos, dev, torch.int64),
                               _as(sig, dev, torch.int64), wts,
                               pdfdict.Ngrid)


def kde_stack_gathered(y, y_std, wts, grid, dx=None, sig_thresh=5.0):
    """Grid (non-dict) variant of `kde_stack_gathered_dict`: ``y``,
    ``y_std``, ``wts`` are (Nobj, J) per-object labels and weights."""
    wts = _as(wts)
    dev = wts.device
    grid = _as(grid, dev)
    if dx is None:
        dx = grid[1] - grid[0]
    return _kde_stack_gathered_grid(_as(y, dev), _as(y_std, dev), wts, grid,
                                    dx, sig_thresh)


def pack_label_spec(label_dict, label_grid, model_labels, model_label_errs,
                    dx=None, sig_thresh=5.0, device=None, dtype=None):
    """``(use_dict, ngrid, lab)`` for the gathered stacks.

    With a `PDFDict`, `lab` is (sigmas, widths, delta, full_pos,
    full_sig); with a grid, (labels, label_errs, grid, dx, sig_thresh):
    tensors on `device` (floats in `dtype`, or as given), the scalars as
    Python numbers or tensors.  Shared by the network's streaming path
    and the stacks of stored fits.
    """
    if label_dict is not None:
        fp, fs = label_dict.fit(np.asarray(model_labels),
                                np.asarray(model_label_errs))
        lab = (_as(label_dict.sigma_grid, device, dtype),
               _as(label_dict.sigma_width, device, torch.int64),
               float(label_dict.delta), _as(fp, device, torch.int64),
               _as(fs, device, torch.int64))
        return True, label_dict.Ngrid, lab
    if label_grid is None:
        raise ValueError("`label_dict` or `label_grid` must be "
                         "specified.")
    grid = _as(label_grid, device, dtype)
    lab = (_as(model_labels, device, dtype),
           _as(model_label_errs, device, dtype), grid,
           grid[1] - grid[0] if dx is None else dx, float(sig_thresh))
    return False, grid.shape[0], lab


def gauss_kde(y, y_std, x, dx=None, y_wt=None, sig_thresh=5.0,
              wt_thresh=1e-3, cdf_thresh=2e-4, **kwargs):
    """Drop-in batched `gauss_kde` (pdf.py:444-526): `y_wt` (Ny,) gives
    one PDF (Nx,), (Nobj, Ny) a batch (Nobj, Nx)."""
    y = _as(y)
    y_wt = torch.ones_like(y) if y_wt is None else _as(y_wt, y.device)
    G = kernel_matrix(y, _as(y_std, y.device), _as(x, y.device), dx=dx,
                      sig_thresh=sig_thresh)
    out = kde_stack(torch.atleast_2d(y_wt), G, wt_thresh, cdf_thresh)
    return out[0] if y_wt.ndim == 1 else out


def gauss_kde_dict(pdfdict, y=None, y_std=None, y_idx=None, y_std_idx=None,
                   y_wt=None, wt_thresh=1e-3, cdf_thresh=2e-4, **kwargs):
    """Drop-in batched `gauss_kde_dict` (pdf.py:529-622)."""
    if y_idx is None or y_std_idx is None:
        if y is None or y_std is None:
            raise ValueError("provide (y, y_std) or (y_idx, y_std_idx)")
        y_idx, y_std_idx = pdfdict.fit(y, y_std)
    y_idx = np.asarray(y_idx)
    y_wt = (torch.ones(y_idx.shape[0], dtype=torch.float32) if y_wt is None
            else _as(y_wt))
    G = kernel_matrix_dict(pdfdict, y_idx, y_std_idx, device=y_wt.device)
    out = kde_stack(torch.atleast_2d(y_wt), G, wt_thresh, cdf_thresh)
    return out[0] if y_wt.ndim == 1 else out
