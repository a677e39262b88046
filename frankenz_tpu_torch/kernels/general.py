"""Wrappers and plain versions of the general (masked) lnl kernels.

`lnl_reduce`, `lnl_stack`, `lnl_topk` and `lnl_cut_stack` replace the
Pallas kernels `_make_reduce_kernel` (frankenz_tpu/ops/fused.py:599),
`_make_stack_kernel` (:634), `_make_topk_kernel` (:721) and
`_make_cut_stack_kernel` (:779) with the fixed-scale branch of their
shared `_lnl_tile` (:316); `lnl_reduce_split`, the reduce on either side
of a per-object value, serves the bisection that finds a cdf cut the
top-T table leaves undetermined (`ops.fused.cdf_cut_exact`).  The CUDA
sources, with the design notes, are in ``csrc/lnl_general.cu``.

Each wrapper takes float32 contiguous tensors:

* ``d``, ``de``, ``dm``: (B, F) data, errors and 0/1 mask;
* ``mT``, ``meT``, ``mmT``: (F, M) model photometry, errors and mask,
  pre-transposed;
* ``G``: (M, Ngrid) kernel matrix and the per-object (B,) rows the
  stack kernels read (``lmap``, ``levid``, ``cut``).

and three flags that pick the kernel's instantiation: ``full_mask``
(both masks all ones: the mask products and Ndim drop out),
``dim_prior`` (chi^2-distribution prior; False: Normal likelihood) and
``ignore_model_err``.

On a CPU tensor a wrapper runs its plain PyTorch version; on a CUDA
tensor it launches the kernel or raises: there is no fallback.  Each
wrapper counts its launches in ``<wrapper>.launches``.

The plain versions compute the (B, M) lnl grid with `lnl_tile_plain`,
in the kernels' order (filters k = 0..F-1, ``iv = 1/var``, ``term =
(mask * r^2) * iv``, the same normalization table), so on the card lnl
agrees with the kernels' bit for bit up to the last ulp of `log`; the
sums and the stack product run in another order.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import gammaln as _sp_gammaln

from ..ops.kde import fp32_matmul
from . import build as _build
from .fullmask import _SMEM_MAX, _STACK_MAX_THREADS, _check

__all__ = ["lnl_tile_plain", "lnl_reduce", "lnl_reduce_plain",
           "lnl_reduce_split", "lnl_reduce_split_plain", "lnl_stack",
           "lnl_stack_plain", "lnl_topk", "lnl_topk_plain", "lnl_cut_stack",
           "lnl_cut_stack_plain", "gl_table", "NEG_INF",
           "reset_launch_counts", "launch_counts"]

NEG_INF = float(np.finfo(np.float32).min)  # the lnl floor
_LOG_2 = 0.6931471805599453
_LOG_2PI = 1.8378770664093453

# Built once per (F, device): a host-to-device copy from pageable memory
# on every launch would synchronize the host with the stream.
_GL_CACHE = {}


def gl_table(nfilt, device):
    """(F+1,) float32 table of gammaln(k/2) + (k/2) ln 2, k = 0..F, with
    +inf at k = 0 (ops/fused.py:1855-1856): the dim-prior normalization
    for Ndim = k."""
    dev = torch.device(device)
    key = (int(nfilt), dev.type, dev.index)
    table = _GL_CACHE.get(key)
    if table is None:
        vals = [float(_sp_gammaln(0.5 * k) + _LOG_2 * 0.5 * k) if k > 0
                else float("inf") for k in range(int(nfilt) + 1)]
        table = torch.tensor(vals, dtype=torch.float32, device=dev)
        _GL_CACHE[key] = table
    return table


def _nd_full(nfilt):
    """float32(F log 2 pi): the Normal likelihood's Ndim term on full
    masks, as the JAX tile forms it from a Python float."""
    return float(np.float32(nfilt * _LOG_2PI))


def _check_inputs(d, de, dm, mT, meT, mmT):
    if d.ndim != 2 or mT.ndim != 2:
        raise ValueError("d must be (B, F) and mT (F, M)")
    B, F = d.shape
    M = mT.shape[1]
    if F < 1 or M < 1:
        raise ValueError("need at least one filter and one model")
    dev = d.device
    for name, t in (("d", d), ("de", de), ("dm", dm)):
        _check(name, t, (B, F), dev)
    for name, t in (("mT", mT), ("meT", meT), ("mmT", mmT)):
        _check(name, t, (F, M), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return B, F, M


def _check_smem(name, smem):
    if smem > _SMEM_MAX:
        raise ValueError(f"{name}: needs {smem} bytes of shared memory "
                         f"per block (limit {_SMEM_MAX})")


def _check_rc(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _flags(full_mask, dim_prior, ignore_model_err):
    return [int(bool(full_mask)), int(bool(dim_prior)),
            int(bool(ignore_model_err))]


def lnl_tile_plain(d, de, dm, mT, meT, mmT, *, full_mask=False,
                   dim_prior=True, ignore_model_err=False):
    """The (B, M) lnl grid in the kernels' order (`_lnl_tile`'s fixed
    scale branch, ops/fused.py:345-386 and :415-449), floored at float32
    min."""
    B, F = d.shape
    de2 = de * de
    me2 = meT * meT
    chi2 = torch.zeros((B, mT.shape[1]), dtype=d.dtype, device=d.device)
    ndim = None if full_mask else torch.zeros_like(chi2)
    logvar = torch.zeros((B, 1), dtype=d.dtype, device=d.device)
    for k in range(F):
        var = (de2[:, k:k + 1] if ignore_model_err
               else de2[:, k:k + 1] + me2[k])
        r = d[:, k:k + 1] - mT[k]
        iv = 1.0 / var
        if full_mask:
            term = (r * r) * iv
        else:
            mask = dm[:, k:k + 1] * mmT[k]
            term = (mask * (r * r)) * iv
            ndim = ndim + mask
        chi2 = chi2 + term
        if not dim_prior:
            logvar = logvar + torch.log(var)
    if dim_prior:
        gl = gl_table(F, d.device)
        # where(), not clamp: NaN passes through, as in jnp.maximum.
        safe = torch.where(chi2 < 1e-30, 1e-30, chi2)
        if full_mask:
            a1 = 0.5 * F - 1.0
            xl = a1 * torch.log(safe) if a1 != 0.0 else torch.zeros_like(chi2)
            norm = gl[F]
        else:
            a1 = 0.5 * ndim - 1.0
            xl = torch.where(a1 == 0.0, 0.0, a1 * torch.log(safe))
            whole = (ndim >= 1.0) & (ndim <= F) & (ndim == torch.trunc(ndim))
            norm = gl[torch.where(whole, ndim, 0.0).long()]
        lnl = (xl - 0.5 * chi2) - norm
    else:
        ndt = _nd_full(F) if full_mask else ndim * _LOG_2PI
        lnl = (-0.5 * chi2) - 0.5 * (ndt + logvar)
    return torch.where(lnl < NEG_INF, NEG_INF, lnl)


def lnl_reduce_plain(d, de, dm, mT, meT, mmT, **flags):
    """Plain version of `lnl_reduce`: (lmap, levid), each (B,)."""
    lnl = lnl_tile_plain(d, de, dm, mT, meT, mmT, **flags)
    lmap = lnl.amax(dim=1)
    levid = torch.log(torch.exp(lnl - lmap[:, None]).sum(dim=1)) + lmap
    return lmap, levid


def _lse(lnl, keep):
    m = torch.where(keep, lnl, -torch.inf).amax(dim=1)
    m = torch.where(m > NEG_INF, m, NEG_INF)
    w = torch.where(keep, torch.exp(lnl - m[:, None]), 0.0)
    return torch.log(w.sum(dim=1)) + m


def lnl_reduce_split_plain(d, de, dm, mT, meT, mmT, split, **flags):
    """Plain version of `lnl_reduce_split`: (levid_gt, levid_le,
    count_gt), each (B,)."""
    lnl = lnl_tile_plain(d, de, dm, mT, meT, mmT, **flags)
    gt = lnl > split[:, None]
    return (_lse(lnl, gt), _lse(lnl, lnl <= split[:, None]),
            gt.to(d.dtype).sum(dim=1))


def lnl_topk_plain(d, de, dm, mT, meT, mmT, *, T, **flags):
    """Plain version of `lnl_topk`: (vals, cnts), each (B, T)."""
    lnl = lnl_tile_plain(d, de, dm, mT, meT, mmT, **flags)
    lnl = torch.where(torch.isnan(lnl), NEG_INF, lnl)
    s = torch.sort(lnl, dim=1, descending=True).values
    new = torch.ones_like(s, dtype=torch.bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    gid = torch.cumsum(new.to(torch.int64), dim=1) - 1
    keep = (gid < T) & (s > NEG_INF)
    # Column T collects everything not kept and is dropped.
    idx = torch.where(keep, gid, T)
    vals = torch.full((s.shape[0], T + 1), NEG_INF, dtype=s.dtype,
                      device=s.device)
    cnts = torch.zeros_like(vals)
    vals.scatter_(1, idx, torch.where(keep, s, NEG_INF))
    cnts.scatter_add_(1, idx, keep.to(s.dtype))
    return vals[:, :T].contiguous(), cnts[:, :T].contiguous()


def lnl_stack_plain(d, de, dm, mT, meT, mmT, G, lmap, levid, *, log_thr,
                    **flags):
    """Plain version of `lnl_stack`: pdf (B, Ngrid)."""
    lnl = lnl_tile_plain(d, de, dm, mT, meT, mmT, **flags)
    thr = lmap + float(np.float32(log_thr))
    w = torch.where(lnl > thr[:, None], torch.exp(lnl - levid[:, None]), 0.0)
    return fp32_matmul(w, G)


def lnl_cut_stack_plain(d, de, dm, mT, meT, mmT, G, cut, levid, tie, nkeep,
                        **flags):
    """Plain version of `lnl_cut_stack`: pdf (B, Ngrid)."""
    lnl = lnl_tile_plain(d, de, dm, mT, meT, mmT, **flags)
    is_tie = lnl == tie[:, None]
    rank = torch.cumsum(is_tie.to(torch.int32), dim=1) - 1
    keep = (lnl <= cut[:, None]) | (is_tie & (rank < nkeep[:, None]))
    w = torch.where(keep, torch.exp(lnl - levid[:, None]), 0.0)
    return fp32_matmul(w, G)


def lnl_reduce(d, de, dm, mT, meT, mmT, *, full_mask=False, dim_prior=True,
               ignore_model_err=False):
    """Per object over all models: lmap = max lnl and levid = log sum
    exp(lnl - lmap) + lmap.  Returns (lmap, levid), float32 (B,)."""
    B, F, M = _check_inputs(d, de, dm, mT, meT, mmT)
    flags = dict(full_mask=full_mask, dim_prior=dim_prior,
                 ignore_model_err=ignore_model_err)
    if d.device.type == "cpu":
        return lnl_reduce_plain(d, de, dm, mT, meT, mmT, **flags)
    lmap = torch.empty(B, dtype=torch.float32, device=d.device)
    levid = torch.empty_like(lmap)
    if B == 0:
        return lmap, levid
    lib = _build.load()
    _check_smem("lnl_reduce", lib.fz_lnl_reduce_smem(F))
    gl = gl_table(F, d.device)
    with torch.cuda.device(d.device):
        rc = lib.fz_lnl_reduce(
            *_ptrs(d, de, dm, mT, meT, mmT, gl, lmap, levid), B, M, F,
            *_flags(**flags), _nd_full(F), _stream(d.device))
    _check_rc("lnl_reduce", rc)
    lnl_reduce.launches += 1
    return lmap, levid


def lnl_reduce_split(d, de, dm, mT, meT, mmT, split, *, full_mask=False,
                     dim_prior=True, ignore_model_err=False):
    """Per object, log sum exp(lnl) over the models with lnl > split[b]
    and over those with lnl <= split[b] (NaN joins neither), each summed
    from its own terms, and the count of the first.  Returns (levid_gt,
    levid_le, count_gt), float32 (B,); an empty side gives -inf."""
    B, F, M = _check_inputs(d, de, dm, mT, meT, mmT)
    _check("split", split, (B,), d.device)
    flags = dict(full_mask=full_mask, dim_prior=dim_prior,
                 ignore_model_err=ignore_model_err)
    if d.device.type == "cpu":
        return lnl_reduce_split_plain(d, de, dm, mT, meT, mmT, split,
                                      **flags)
    gt = torch.empty(B, dtype=torch.float32, device=d.device)
    le = torch.empty_like(gt)
    count = torch.empty_like(gt)
    if B == 0:
        return gt, le, count
    lib = _build.load()
    _check_smem("lnl_reduce_split", lib.fz_lnl_reduce_smem(F))
    gl = gl_table(F, d.device)
    with torch.cuda.device(d.device):
        rc = lib.fz_lnl_reduce_split(
            *_ptrs(d, de, dm, mT, meT, mmT, gl, split, gt, le, count),
            B, M, F, *_flags(**flags), _nd_full(F), _stream(d.device))
    _check_rc("lnl_reduce_split", rc)
    lnl_reduce_split.launches += 1
    return gt, le, count


def lnl_topk(d, de, dm, mT, meT, mmT, *, T, full_mask=False, dim_prior=True,
             ignore_model_err=False):
    """Per object, the T largest distinct lnl values (descending) and
    their tie counts; unused slots hold float32 min and count 0.
    Returns (vals, cnts), float32 (B, T)."""
    B, F, M = _check_inputs(d, de, dm, mT, meT, mmT)
    T = int(T)
    if T < 1:
        raise ValueError(f"T={T}: need at least one slot")
    flags = dict(full_mask=full_mask, dim_prior=dim_prior,
                 ignore_model_err=ignore_model_err)
    if d.device.type == "cpu":
        return lnl_topk_plain(d, de, dm, mT, meT, mmT, T=T, **flags)
    vals = torch.empty((B, T), dtype=torch.float32, device=d.device)
    cnts = torch.empty_like(vals)
    if B == 0:
        return vals, cnts
    lib = _build.load()
    _check_smem("lnl_topk", lib.fz_lnl_topk_smem(F, T))
    gl = gl_table(F, d.device)
    with torch.cuda.device(d.device):
        rc = lib.fz_lnl_topk(
            *_ptrs(d, de, dm, mT, meT, mmT, gl, vals, cnts), B, M, F, T,
            *_flags(**flags), _nd_full(F), _stream(d.device))
    _check_rc("lnl_topk", rc)
    lnl_topk.launches += 1
    return vals, cnts


def _check_stack_inputs(d, G, M, rows):
    if G.ndim != 2 or G.shape[1] < 1:
        raise ValueError("G must be (M, Ngrid) with Ngrid >= 1")
    _check("G", G, (M, G.shape[1]), d.device)
    for name, t in rows.items():
        _check(name, t, (d.shape[0],), d.device)


def _launch_stack(name, fn, d, de, dm, mT, meT, mmT, G, rowv, levid, B, M,
                  F, extra, flags, rows=()):
    ngrid = G.shape[1]
    pdf = torch.empty((B, ngrid), dtype=torch.float32, device=d.device)
    if B == 0:
        return pdf
    lib = _build.load()
    _check_smem(name, lib.fz_lnl_stack_smem(F))
    gl = gl_table(F, d.device)
    threads = min(-(-ngrid // 32) * 32, _STACK_MAX_THREADS)
    with torch.cuda.device(d.device):
        rc = getattr(lib, fn)(
            *_ptrs(d, de, dm, mT, meT, mmT, gl, G, rowv, levid, *rows, pdf),
            B, M,
            F, ngrid, *extra, *_flags(**flags), _nd_full(F), threads,
            _stream(d.device))
    _check_rc(name, rc)
    return pdf


def lnl_stack(d, de, dm, mT, meT, mmT, G, lmap, levid, *, log_thr,
              full_mask=False, dim_prior=True, ignore_model_err=False):
    """pdf = sum over models of exp(lnl - levid) * G[m], keeping pairs
    with lnl > float32(log_thr) + lmap (the sum rounded in float32).
    Returns pdf (B, Ngrid), float32, in the exp(lnl - levid) scale."""
    B, F, M = _check_inputs(d, de, dm, mT, meT, mmT)
    _check_stack_inputs(d, G, M, dict(lmap=lmap, levid=levid))
    flags = dict(full_mask=full_mask, dim_prior=dim_prior,
                 ignore_model_err=ignore_model_err)
    if d.device.type == "cpu":
        return lnl_stack_plain(d, de, dm, mT, meT, mmT, G, lmap, levid,
                               log_thr=log_thr, **flags)
    pdf = _launch_stack("lnl_stack", "fz_lnl_stack", d, de, dm, mT, meT,
                        mmT, G, lmap, levid, B, M, F,
                        [float(np.float32(log_thr))], flags)
    lnl_stack.launches += 1
    return pdf


def lnl_cut_stack(d, de, dm, mT, meT, mmT, G, cut, levid, tie, nkeep, *,
                  full_mask=False, dim_prior=True, ignore_model_err=False):
    """As `lnl_stack`, keeping pairs with lnl <= cut[b] and the first
    nkeep[b] models (in model order) with lnl == tie[b] (see
    `ops.fused.cdf_cut`).  Returns pdf (B, Ngrid), float32, in the
    exp(lnl - levid) scale."""
    B, F, M = _check_inputs(d, de, dm, mT, meT, mmT)
    _check_stack_inputs(d, G, M, dict(cut=cut, levid=levid, tie=tie,
                                      nkeep=nkeep))
    flags = dict(full_mask=full_mask, dim_prior=dim_prior,
                 ignore_model_err=ignore_model_err)
    if d.device.type == "cpu":
        return lnl_cut_stack_plain(d, de, dm, mT, meT, mmT, G, cut, levid,
                                   tie, nkeep, **flags)
    pdf = _launch_stack("lnl_cut_stack", "fz_lnl_cut_stack", d, de, dm, mT,
                        meT, mmT, G, cut, levid, B, M, F, [], flags,
                        rows=(tie, nkeep))
    lnl_cut_stack.launches += 1
    return pdf


lnl_reduce.launches = 0
lnl_reduce_split.launches = 0
lnl_stack.launches = 0
lnl_topk.launches = 0
lnl_cut_stack.launches = 0

_WRAPPERS = (lnl_reduce, lnl_reduce_split, lnl_stack, lnl_topk,
             lnl_cut_stack)


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts():
    """{wrapper name: launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
