"""
Diagnostics and plotting (port of `frankenz_tpu.plotting`).

Reference: `frankenz/plotting.py` (`input_vs_pdf` :31, `input_vs_dpdf`
:184, `cdf_vs_epdf` :369, `cdf_vs_ecdf` :443, `plot2d_network` :524,
`plot_node` :681).

The preparation that the JAX module jits and vmaps runs here as plain
torch in float64: the outer weight selection, the per-row PDF
thresholding and renormalization, the recentring interpolation of
`input_vs_dpdf`, the coverage tests' CDF interpolation and the 2-D stack
``(w * Gx).T @ Pn`` (one product: the joint normalization factorizes).
It runs on the device of the first tensor among the inputs (the PDFs
first), else on the CPU; results come back as NumPy.
The Monte-Carlo draws stay NumPy `Generator` draws, as in the JAX
module, so both packages see the same draws.  Rendering is host-side
matplotlib, imported only inside `_plt()`: with ``plot=False`` nothing
here needs it.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from .ops import kde as _kde

__all__ = ["input_vs_pdf", "input_vs_dpdf", "cdf_vs_epdf", "cdf_vs_ecdf",
           "plot2d_network", "plot_node"]

_F64 = torch.float64


def _plt():
    import matplotlib.pyplot as plt

    return plt


def _device(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _t(x, device):
    return torch.as_tensor(x, dtype=_F64, device=device)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _keep_cdf(vals, thresh, normalize):
    """Mask of the cells whose ascending cumulative mass (normalized to
    the row's total or not) stays <= 1 - thresh, in the caller's order
    (stable sort: ties keep their order)."""
    order = torch.sort(vals, dim=-1, stable=True).indices
    cs = torch.cumsum(torch.gather(vals, -1, order), dim=-1)
    if normalize:
        cs = cs / cs[..., -1:]
    return torch.zeros(vals.shape, dtype=torch.bool,
                       device=vals.device).scatter(-1, order,
                                                   cs <= (1.0 - thresh))


def _outer_weight_sel(weights, nobj, wt_thresh, cdf_thresh, device):
    """Per-object stacking weights after the outer thresholding
    (plotting.py:93-107)."""
    if weights is None:
        weights = np.ones(nobj, np.float32)
    w = _t(weights, device)
    if wt_thresh is not None:
        return torch.where(w > float(wt_thresh) * w.max(), w, 0.0)
    if cdf_thresh is not None:
        return torch.where(_keep_cdf(w, float(cdf_thresh), True), w, 0.0)
    return w


def _threshold_renorm_pdfs(P, pdf_wt_thresh, pdf_cdf_thresh):
    """Per-row PDF thresholding and renormalization (plotting.py:138-144).

    As in the reference (and the JAX module), the plotting cdf cut runs
    on the unnormalized cumulative sum (plotting.py:325-328), so the kept
    mass depends on the row's sum; `input_vs_dpdf`'s resampled rows no
    longer sum to 1.
    """
    if pdf_wt_thresh is not None:
        keep = P > P.max(dim=1, keepdim=True).values * float(pdf_wt_thresh)
        P = torch.where(keep, P, 0.0)
    elif pdf_cdf_thresh is not None:
        P = torch.where(_keep_cdf(P, float(pdf_cdf_thresh), False), P, 0.0)
    norm = P.sum(dim=1, keepdim=True)
    pos = norm > 0
    return torch.where(pos, P / torch.where(pos, norm, 1.0), 0.0)


def _interp(x, xp, fp):
    """`jnp.interp(x, xp, fp)` row by row: x (B, m) or (m,), xp (B, n) or
    (n,), fp (B, n); the ends clamp to fp's first and last values."""
    B, n = fp.shape
    x = x.expand(B, -1).contiguous()
    xp = xp.expand(B, n).contiguous()
    i = torch.searchsorted(xp, x, right=True).clamp(1, n - 1)
    x0, x1 = torch.gather(xp, 1, i - 1), torch.gather(xp, 1, i)
    f0, f1 = torch.gather(fp, 1, i - 1), torch.gather(fp, 1, i)
    dx = x1 - x0
    tiny = np.spacing(np.finfo(np.float64).eps)
    dx0 = dx.abs() <= tiny
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx))
                    * (f1 - f0))
    f = torch.where(x < xp[:, :1], fp[:, :1], f)
    return torch.where(x > xp[:, -1:], fp[:, -1:], f)


def _stack2d(vals, errs, vdict, Pn, weights):
    """(Ngrid_x, Ngrid_y) density stack = (w * Gx).T @ Pn."""
    vidx, eidx = vdict.fit(_host(vals), _host(errs))
    Gx = _kde.kernel_matrix_dict(vdict, vidx, eidx, device=Pn.device)
    W = weights[:, None] * Gx.to(_F64)
    return (W.T @ Pn).cpu().numpy()


def _render_stack(stack, plot_thresh, extent, cmap, plot_kwargs):
    plt = _plt()
    img = np.array(stack)
    img[img < plot_thresh] = np.nan
    plt.imshow(img.T, origin="lower", aspect="auto", extent=extent,
               cmap=cmap, **(plot_kwargs or {}))
    plt.colorbar(label="Number Density")
    return plt


def input_vs_pdf(vals, errs, vdict, pdfs, pgrid, weights=None,
                 pdf_wt_thresh=1e-3, pdf_cdf_thresh=2e-4, wt_thresh=1e-3,
                 cdf_thresh=2e-4, plot_thresh=0.0, cmap="viridis", smooth=0,
                 plot_kwargs=None, verbose=False, plot=True, **kwargs):
    """2-D stack of input values vs predicted PDFs (plotting.py:31-181).

    Returns the (Ngrid_x, Ngrid_y) stacked density; with ``plot=True``
    also renders the reference's imshow panel.
    """
    del verbose
    dev = _device(pdfs, vals, weights)
    weights = _outer_weight_sel(weights, len(vals), wt_thresh, cdf_thresh,
                                dev)
    Pn = _threshold_renorm_pdfs(_t(pdfs, dev), pdf_wt_thresh,
                                pdf_cdf_thresh)
    stack = _stack2d(vals, errs, vdict, Pn, weights)
    if smooth != 0:
        stack = gaussian_filter(stack, smooth)
    if plot:
        pgrid = _host(pgrid)
        plt = _render_stack(stack, plot_thresh,
                            (vdict.grid[0], vdict.grid[-1], pgrid[0],
                             pgrid[-1]), cmap, plot_kwargs)
        plt.xlim([vdict.grid[0], vdict.grid[-1]])
        plt.ylim([pgrid[0], pgrid[-1]])
        plt.xlabel("Input")
        plt.ylabel("Predicted")
        plt.tight_layout()
    return stack


def input_vs_dpdf(vals, errs, vdict, pdfs, pgrid, pdf_cent, dgrid,
                  disp_func=None, disp_args=(), disp_kwargs=None,
                  weights=None, pdf_wt_thresh=1e-3, pdf_cdf_thresh=2e-4,
                  wt_thresh=1e-3, cdf_thresh=2e-4, plot_thresh=0.0,
                  cmap="viridis", smooth=0, plot_kwargs=None, verbose=False,
                  plot=True, **kwargs):
    """2-D stack of inputs vs *centered-dispersion* PDFs
    (plotting.py:184-366): each PDF is resampled onto `dgrid` in the
    dispersion coordinate ``disp_func(pgrid, pdf_cent)`` (default
    ``pgrid - cent``) before stacking.  `disp_func` is called once, on a
    (1, Ngrid) tensor of the grid and an (Nobj, 1) tensor of the centres,
    and must broadcast to (Nobj, Ngrid)."""
    del verbose
    disp_kwargs = disp_kwargs or {}
    if disp_func is None:
        def disp_func(pg, cent):
            return pg - cent
    dev = _device(pdfs, vals, weights)
    weights = _outer_weight_sel(weights, len(vals), wt_thresh, cdf_thresh,
                                dev)
    P = _t(pdfs, dev)
    dx = disp_func(_t(pgrid, dev)[None, :], _t(pdf_cent, dev)[:, None],
                   *disp_args, **disp_kwargs)
    dpdfs = _interp(_t(dgrid, dev)[None, :], dx.expand(P.shape), P)
    Pn = _threshold_renorm_pdfs(dpdfs, pdf_wt_thresh, pdf_cdf_thresh)
    stack = _stack2d(vals, errs, vdict, Pn, weights)
    if smooth != 0:
        stack = gaussian_filter(stack, smooth)
    if plot:
        dgrid = _host(dgrid)
        plt = _render_stack(stack, plot_thresh,
                            (vdict.grid[0], vdict.grid[-1], dgrid[0],
                             dgrid[-1]), cmap, plot_kwargs)
        plt.xlabel("Input")
        plt.ylabel("Predicted")
        plt.tight_layout()
    return stack


def _cdf_draws(vals, errs, pdfs, pdf_grid, Nmc, rng):
    """(Nobj, Nmc) CDF values at MC-jittered truths (plotting.py:421-428)."""
    vals, errs = _host(vals), _host(errs)
    mc = rng.normal(vals[:, None], errs[:, None], (len(vals), Nmc))
    dev = _device(pdfs)
    cdf = torch.cumsum(_t(pdfs, dev), dim=1)
    cdf = cdf / cdf[:, -1:]
    return _interp(_t(mc, dev), _t(pdf_grid, dev), cdf).cpu().numpy()


def cdf_vs_epdf(vals, errs, pdfs, pdf_grid, Nmc=100, weights=None,
                Nbins=50, plot_kwargs=None, rng=None, seed=None, plot=True,
                **kwargs):
    """Coverage test: histogram of CDF values at MC-jittered truths
    (plotting.py:369-440).  Well-calibrated PDFs give ~Uniform(0,1).
    Returns the normalized bin counts."""
    nobj = len(vals)
    rng = rng if rng is not None else np.random.default_rng(seed)
    if weights is None:
        weights = np.ones(nobj, np.float32)
    w = np.repeat(np.asarray(_host(weights), float), Nmc)
    draws = _cdf_draws(vals, errs, pdfs, pdf_grid, Nmc, rng).ravel()
    bins = np.linspace(0.0, 1.0, Nbins + 1)
    n, _ = np.histogram(draws, bins=bins, weights=w, density=True)
    if plot:
        plt = _plt()
        pk = plot_kwargs or {"color": "blue", "alpha": 0.6}
        plt.hist(draws, bins=bins, weights=w, density=True, **pk)
        plt.xlabel("CDF Draws")
        plt.ylabel("Normalized Counts")
    return n


def cdf_vs_ecdf(vals, errs, pdfs, pdf_grid, Nmc=100, weights=None,
                plot_kwargs=None, rng=None, seed=None, plot=True, **kwargs):
    """Coverage test: sorted CDF draws vs the weighted empirical CDF
    (plotting.py:443-521).  Returns (x, y); calibrated PDFs give y ~ x."""
    nobj = len(vals)
    rng = rng if rng is not None else np.random.default_rng(seed)
    if weights is None:
        weights = np.ones(nobj, np.float32)
    w = np.repeat(np.asarray(_host(weights), float), Nmc)
    draws = _cdf_draws(vals, errs, pdfs, pdf_grid, Nmc, rng).ravel()
    order = np.argsort(draws)
    ds, ws = draws[order], w[order]
    dd = np.append(ds[0], np.diff(ds))
    x = np.cumsum(ws) / ws.sum()
    y = np.cumsum(ws * dd)
    y = y / y[-1]
    if plot:
        plt = _plt()
        pk = plot_kwargs or {"color": "blue", "alpha": 0.6}
        plt.plot(x, y, **pk)
        plt.xlabel("Sorted CDF Draws")
        plt.ylabel("Empirical CDF")
    return x, y


def _weighted_median(ys, wts):
    order = np.argsort(ys)
    cdf = np.cumsum(wts[order])
    return np.interp(0.5, cdf, ys[order])


def plot2d_network(network, counts="weighted", label_name=None, labels=None,
                   labels_err=None, vals=None, dims=(0, 1), cmap="viridis",
                   Nmc=5, point_est="median", plot_kwargs=None, rng=None,
                   seed=None, discrete=False, verbose=True, plot=True,
                   **kwargs):
    """Scatter the network's projected nodes coloured by a per-node value
    (plotting.py:524-678): member counts, weighted counts (a logsumexp of
    the member log-weights, in torch on the network's device), or a
    weighted point estimate (mean/median/std/mad or a custom
    ``f(labels, wts)``) of member labels (with optional Monte Carlo label
    errors)."""
    del verbose
    rng = rng if rng is not None else np.random.default_rng(seed)
    nnodes = network.NNODE
    xpos = np.asarray(network.nodes_pos)[:, dims[0]]
    ypos = np.asarray(network.nodes_pos)[:, dims[1]]
    if label_name is None and (labels is not None or vals is not None):
        label_name = "Node Value"

    if vals is None and labels is None:
        if counts == "absolute":
            vals = np.asarray(network.nodes_Nmatch, float)
            label_name = label_name or "Counts"
        elif counts == "weighted":
            lw = _t(np.asarray(network.nodes_logwts, float),
                    getattr(network, "device", None))
            vals = torch.exp(torch.logsumexp(lw, dim=1)).cpu().numpy()
            label_name = label_name or "Weighted Counts"
        else:
            raise ValueError("unknown `counts` option: {!r}".format(counts))

    if vals is None and labels is not None:
        labels = np.asarray(labels)
        vals = np.zeros(nnodes)
        for i in range(nnodes):
            n = int(network.nodes_Nmatch[i] if not discrete
                    else network.nodes_Nbmu[i])
            if n == 0:
                vals[i] = np.nan
                continue
            if discrete:
                idxs = network.nodes_bmus[i, :n]
                wts = np.full(n, 1.0 / n)
            else:
                idxs = network.nodes_idxs[i, :n]
                lw = network.nodes_logwts[i, :n]
                wts = np.exp(lw - lw.max())
                wts /= wts.sum()
            ys = labels[idxs]
            if labels_err is not None:
                yes = np.asarray(labels_err)[idxs]
                ys = rng.normal(np.tile(ys, Nmc), np.tile(yes, Nmc))
                wts = np.tile(wts, Nmc) / Nmc
            if point_est == "mean":
                vals[i] = wts @ ys
            elif point_est == "median":
                vals[i] = _weighted_median(ys, wts)
            elif point_est == "std":
                vals[i] = wts @ np.square(ys - wts @ ys)
            elif point_est == "mad":
                med = _weighted_median(ys, wts)
                vals[i] = _weighted_median(np.abs(ys - med), wts)
            elif callable(point_est):
                vals[i] = point_est(ys, wts)
            else:
                raise ValueError("unknown `point_est`: {!r}"
                                 .format(point_est))

    if plot:
        plt = _plt()
        plt.scatter(xpos, ypos, c=vals, cmap=cmap, **(plot_kwargs or {}))
        plt.xlabel(r"$x_{}$".format(dims[0]))
        plt.ylabel(r"$x_{}$".format(dims[1]))
        plt.colorbar(label=label_name)
    return vals


def plot_node(network, models, models_err, pos=None, idx=None,
              models_x=None, Nrsamp=1, Nmc=5, node_kwargs=None,
              violin_kwargs=None, rng=None, seed=None, discrete=False,
              plot=True, **kwargs):
    """Violin plot of one node's member photometry vs the node model
    (plotting.py:681-789).  Members are resampled by weight, Monte Carlo
    jittered by their errors, de-scaled by their fitted scale factors, and
    the node model gets a small least-squares rescaling if needed."""
    rng = rng if rng is not None else np.random.default_rng(seed)
    models = _host(models)
    models_err = _host(models_err)
    if models_x is None:
        models_x = np.arange(models.shape[-1]) + 1

    (idx, node_model, _npos, idxs, logwts, scales,
     scales_err) = network.get_node(pos=pos, idx=idx, discrete=discrete)
    tmodels, tmodels_err = models[idxs], models_err[idxs]
    lw = np.asarray(logwts, float)
    wts = np.exp(lw - lw.max())
    wts /= wts.sum()

    nmatch = len(idxs)
    rs = rng.choice(nmatch, p=wts, size=nmatch * Nrsamp)
    mc = rng.normal(tmodels[rs], tmodels_err[rs])
    snorm = np.mean(np.asarray(scales)[rs])
    mc = mc / (np.asarray(scales)[rs, None] / snorm)

    mean_model = mc.mean(axis=0)
    std_model = mc.std(axis=0)
    num = (mean_model / std_model) @ (node_model / std_model)
    den = (node_model / std_model) @ (node_model / std_model)
    node_scale = num / den
    if abs(node_scale - 1.0) < 0.05:
        node_scale = 1.0

    if plot:
        plt = _plt()
        nk = dict(color="black", marker="*", markersize=10, alpha=0.6)
        nk.update(node_kwargs or {})
        vk = dict(widths=600, showextrema=False)
        vk.update(violin_kwargs or {})
        plt.plot(models_x, node_model * node_scale, **nk)
        for i in range(models.shape[-1]):
            plt.violinplot(mc[:, i], [models_x[i]], **vk)
        plt.ylim([float((mean_model - 3 * std_model).min()),
                  float((mean_model + 3 * std_model).max())])
    return node_model * node_scale, mc
