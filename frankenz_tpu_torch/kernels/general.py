"""Wrappers and plain versions of the general (masked) lnl kernels.

`lnl_reduce`, `lnl_stack`, `lnl_onepass`, `lnl_topk` and
`lnl_cut_stack` replace the Pallas kernels `_make_reduce_kernel`
(frankenz_tpu/ops/fused.py:599), `_make_stack_kernel` (:634),
`_make_onepass_kernel` (:670), `_make_topk_kernel` (:721) and
`_make_cut_stack_kernel` (:779), with both branches of their shared
`_lnl_tile` (:316): fixed scale and free scale (:325-411, and
`_lnl_tile_freescale_me`, :452-596).  `lnl_reduce_split`, the reduce on
either side of a per-object value, serves the bisection that finds a cdf
cut the top-T table leaves undetermined (`ops.fused.cdf_cut_exact`).
`scale_sweeps` counts the free-scale fixed point's sweeps per (object,
model group), the table the other kernels read under free scale with
model errors.  The CUDA sources, with the design notes, are
``csrc/lnl_general.cu`` (fixed scale), ``csrc/lnl_freescale.cu`` (free
scale) and ``csrc/lnl_common.cuh`` (the kernel templates).

Each wrapper takes float32 contiguous tensors:

* ``d``, ``de``, ``dm``: (B, F) data, errors and 0/1 mask;
* ``mT``, ``meT``, ``mmT``: (F, M) model photometry, errors and mask,
  pre-transposed;
* ``G``: (M, Ngrid) kernel matrix and the per-object (B,) rows the
  stack kernels read (``lmap``, ``levid``, ``cut``).

and flags that pick the kernel's instantiation: ``full_mask`` (both
masks all ones: the mask products and Ndim drop out), ``dim_prior``
(chi^2-distribution prior; False: Normal likelihood),
``ignore_model_err`` and ``free_scale`` (the ML model scale).  Free
scale with model errors also takes ``sweeps``, the int16 (B, ceil(M /
tm)) table from `scale_sweeps`, and its group width ``tm``: a pair of
object b and model j runs ``sweeps[b, j // tm]`` sweeps of the scale
recurrence.

On a CPU tensor a wrapper runs its plain PyTorch version; on a CUDA
tensor it launches the kernel or raises: there is no fallback.  Each
wrapper counts its launches in ``<wrapper>.launches``.

The plain versions compute the (B, M) lnl grid with `lnl_tile_plain`,
in the kernels' order (filters k = 0..F-1, ``iv = 1/var``, ``term =
(mask * r^2) * iv``, the same normalization table), so on the card lnl
agrees with the kernels' bit for bit up to the last ulp of `log`, and
`scale_sweeps_plain`'s table equals the kernel's; the sums and the
stack product run in another order.
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
           "lnl_stack_plain", "lnl_onepass", "lnl_onepass_plain",
           "lnl_topk", "lnl_topk_plain", "lnl_cut_stack",
           "lnl_cut_stack_plain", "scale_sweeps", "scale_sweeps_plain",
           "gl_table", "NEG_INF", "reset_launch_counts", "launch_counts"]

NEG_INF = float(np.finfo(np.float32).min)  # the lnl floor
_LOG_2 = 0.6931471805599453
_LOG_2PI = 1.8378770664093453
_EPS = float(np.finfo(np.float32).eps)
# Free-scale chi^2 floor 16 eps A (ops/fused.py:59) and the fixed point's
# roundoff floor 4 eps max A (:530-531): powers of two, exact in float32.
CHI2_NOISE = 16.0 * _EPS
_EPS4 = 4.0 * _EPS
# The JAX glue's model padding (ops/fused.py:2151-2153): the sentinels
# join the last model group's convergence maxima.
_SENTINEL = (float(np.float32(1e15)), 1.0, 0.0)

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


def _flags(full_mask, dim_prior, ignore_model_err, **_):
    return [int(bool(full_mask)), int(bool(dim_prior)),
            int(bool(ignore_model_err))]


def _flag_dict(full_mask, dim_prior, ignore_model_err, free_scale, sweeps,
               tm):
    return dict(full_mask=bool(full_mask), dim_prior=bool(dim_prior),
                ignore_model_err=bool(ignore_model_err),
                free_scale=bool(free_scale), sweeps=sweeps, tm=tm)


def _table_args(B, M, device, *, free_scale, ignore_model_err, sweeps, tm,
                **_):
    """Check the sweep table against the flags; returns (pointer, ng, tm)
    of the C call (a null table outside free scale with model errors)."""
    if not (free_scale and not ignore_model_err):
        if sweeps is not None:
            raise ValueError("a sweep table is read only under free scale "
                             "with model errors")
        return None, 1, 1
    if sweeps is None or tm is None or int(tm) < 1:
        raise ValueError("free scale with model errors needs the sweep "
                         "table from `scale_sweeps` and its group width tm")
    tm = int(tm)
    ng = -(-M // tm)
    if not isinstance(sweeps, torch.Tensor) or sweeps.dtype != torch.int16:
        raise TypeError("sweeps must be an int16 tensor")
    if tuple(sweeps.shape) != (B, ng) or sweeps.device != device \
            or not sweeps.is_contiguous():
        raise ValueError(f"sweeps must be a contiguous ({B}, {ng}) tensor "
                         f"on {device}")
    return sweeps.data_ptr(), ng, tm


def _entry(lib, name, free_scale, **_):
    """The fixed-scale entry point, or its free-scale twin (``_fs``)."""
    return getattr(lib, name + ("_fs" if free_scale else ""))


def _shape_floor(x):
    """max(shape, 1e-30) before the reciprocal; NaN passes through."""
    return torch.where(x < 1e-30, 1e-30, x)


def _fs_var_iv(d, de2, dm, mT, meT, mmT, k, s, full_mask):
    """var(s) = de^2 + (s me)^2 for filter k (s None: the initial
    variance de^2 + me^2) and its masked reciprocal."""
    sme = meT[k] if s is None else s * meT[k]
    var = de2[:, k:k + 1] + sme * sme
    iv = 1.0 / var
    if not full_mask:
        iv = (dm[:, k:k + 1] * mmT[k]) * iv
    return var, iv


def _fs_scale_plain(d, de2, dm, mT, meT, mmT, s, full_mask):
    """One scale update with model errors kept: s -> inter / shape under
    var(s) (the kernels' `scale_step`)."""
    inter = torch.zeros((d.shape[0], mT.shape[1]), dtype=d.dtype,
                        device=d.device)
    shape = torch.zeros_like(inter)
    for k in range(d.shape[1]):
        _, iv = _fs_var_iv(d, de2, dm, mT, meT, mmT, k, s, full_mask)
        mk, dk = mT[k], d[:, k:k + 1]
        inter = inter + iv * (mk * dk)
        shape = shape + iv * (mk * mk)
    return inter * (1.0 / _shape_floor(shape))


def _fs_count_sweep_plain(d, de2, dm, mT, meT, mmT, s, ndt, full_mask):
    """One in-loop sweep of the Pallas tile (ops/fused.py:475-508): the
    new scale, the Normal-form lnl from the ML identity, and A."""
    inter = torch.zeros((d.shape[0], mT.shape[1]), dtype=d.dtype,
                        device=d.device)
    shape, A, logvar = (torch.zeros_like(inter) for _ in range(3))
    for k in range(d.shape[1]):
        var, iv = _fs_var_iv(d, de2, dm, mT, meT, mmT, k, s, full_mask)
        mk, dk = mT[k], d[:, k:k + 1]
        inter = inter + iv * (mk * dk)
        shape = shape + iv * (mk * mk)
        A = A + iv * (dk * dk)
        logvar = logvar + torch.log(var)
    s_new = inter * (1.0 / _shape_floor(shape))
    chi2 = torch.maximum(A - inter * s_new, CHI2_NOISE * A)
    return s_new, (-0.5 * chi2) - 0.5 * (ndt + logvar), A


def scale_sweeps_plain(d, de, dm, mT, meT, mmT, *, tm, full_mask=False,
                       ltol=1e-4, max_iter=100):
    """Plain version of `scale_sweeps`: the int16 (B, ceil(M / tm))
    table of fixed-point sweeps per (object, model group), as the JAX
    tile's while_loop runs them (ops/fused.py:510-544), the models padded
    to a multiple of tm with the JAX glue's sentinels."""
    B, F = d.shape
    M = mT.shape[1]
    tm = int(tm)
    ng = -(-M // tm)
    pad = ng * tm - M
    if pad:
        mT, meT, mmT = (torch.cat([x, torch.full((F, pad), v, dtype=x.dtype,
                                                 device=x.device)], dim=1)
                        for x, v in zip((mT, meT, mmT), _SENTINEL))
    de2 = de * de
    if full_mask:
        ndt = _nd_full(F)
    else:
        ndim = torch.zeros((B, mT.shape[1]), dtype=d.dtype, device=d.device)
        for k in range(F):
            ndim = ndim + dm[:, k:k + 1] * mmT[k]
        ndt = ndim * _LOG_2PI
    s, lnl, _ = _fs_count_sweep_plain(d, de2, dm, mT, meT, mmT, None, ndt,
                                      full_mask)
    count = torch.zeros((B, ng), dtype=torch.int16, device=d.device)
    done = torch.zeros((B, ng), dtype=torch.bool, device=d.device)
    ltol = float(np.float32(ltol))
    it = 0
    while it < int(max_iter) and not bool(done.all()):
        s_n, lnl_n, A_n = _fs_count_sweep_plain(d, de2, dm, mT, meT, mmT, s,
                                                ndt, full_mask)
        delta = (lnl_n - lnl).abs().view(B, ng, tm).amax(dim=2)
        thr = torch.clamp_min(_EPS4 * A_n.view(B, ng, tm).amax(dim=2), ltol)
        live = ~done
        upd = live.repeat_interleave(tm, dim=1)
        s = torch.where(upd, s_n, s)
        lnl = torch.where(upd, lnl_n, lnl)
        it += 1
        count = torch.where(live, it, count).to(torch.int16)
        done = done | (delta <= thr)
    return count


def _fs_tail(chi2, ndim, logvar, F, full_mask, dim_prior):
    """Free-scale lnl from the floored chi^2 (dof = Ndim - 1)."""
    if dim_prior:
        gl = gl_table(F, chi2.device)
        safe = torch.where(chi2 < 1e-30, 1e-30, chi2)
        if full_mask:
            a1 = 0.5 * (F - 1.0) - 1.0
            xl = a1 * torch.log(safe) if a1 != 0.0 else torch.zeros_like(chi2)
            norm = gl[F - 1]
        else:
            a1 = 0.5 * (ndim - 1.0) - 1.0
            xl = torch.where(a1 == 0.0, 0.0, a1 * torch.log(safe))
            whole = (ndim >= 1.0) & (ndim <= F) & (ndim == torch.trunc(ndim))
            norm = gl[torch.where(whole, ndim - 1.0, 0.0).long()]
        lnl = (xl - 0.5 * chi2) - norm
    else:
        ndt = _nd_full(F) if full_mask else ndim * _LOG_2PI
        lnl = (-0.5 * chi2) - 0.5 * (ndt + logvar)
        if not full_mask:
            lnl = torch.where(ndim > 0.0, lnl, NEG_INF)
    return torch.where(lnl < NEG_INF, NEG_INF, lnl)


def _fs_tile_plain(d, de, dm, mT, meT, mmT, *, full_mask, dim_prior,
                   ignore_model_err, sweeps, tm):
    """The free-scale (B, M) lnl grid in the kernels' order (`FreePair`
    of csrc/lnl_freescale.cu)."""
    B, F = d.shape
    M = mT.shape[1]
    de2 = de * de
    zeros = torch.zeros((B, M), dtype=d.dtype, device=d.device)
    chi2, ndim = zeros, zeros
    logvar = torch.zeros((B, 1), dtype=d.dtype, device=d.device)
    if ignore_model_err:
        inter, shape = zeros, zeros
        A = torch.zeros_like(logvar)
        for k in range(F):
            iv = 1.0 / de2[:, k:k + 1]
            dk, mk = d[:, k:k + 1], mT[k]
            it = (dk * iv) * mk
            sh = iv * (mk * mk)
            aa = (dk * dk) * iv
            if not full_mask:
                mask = dm[:, k:k + 1] * mmT[k]
                it, sh, aa = mask * it, mask * sh, mask * aa
                ndim = ndim + mask
            inter = inter + it
            shape = shape + sh
            A = A + aa
            if not dim_prior:
                logvar = logvar + torch.log(de2[:, k:k + 1])
        s = inter * (1.0 / _shape_floor(shape))
        for k in range(F):
            iv = 1.0 / de2[:, k:k + 1]
            r = d[:, k:k + 1] - s * mT[k]
            term = (r * r) * iv
            if not full_mask:
                term = (dm[:, k:k + 1] * mmT[k]) * term
            chi2 = chi2 + term
    else:
        count = sweeps.long()[:, torch.arange(M, device=d.device) // int(tm)]
        s = _fs_scale_plain(d, de2, dm, mT, meT, mmT, None, full_mask)
        prev = s
        for i in range(1, int(count.max()) + 1 if count.numel() else 1):
            s_n = _fs_scale_plain(d, de2, dm, mT, meT, mmT, s, full_mask)
            upd = count >= i
            prev = torch.where(upd, s, prev)
            s = torch.where(upd, s_n, s)
        A = zeros
        logvar = zeros
        for k in range(F):
            var, iv = _fs_var_iv(d, de2, dm, mT, meT, mmT, k, prev, full_mask)
            dk = d[:, k:k + 1]
            r = dk - s * mT[k]
            chi2 = chi2 + iv * (r * r)
            A = A + iv * (dk * dk)
            if not full_mask:
                ndim = ndim + dm[:, k:k + 1] * mmT[k]
            if not dim_prior:
                logvar = logvar + torch.log(var)
    chi2 = torch.maximum(chi2, CHI2_NOISE * A)
    return _fs_tail(chi2, ndim, logvar, F, full_mask, dim_prior)


def lnl_tile_plain(d, de, dm, mT, meT, mmT, *, full_mask=False,
                   dim_prior=True, ignore_model_err=False, free_scale=False,
                   sweeps=None, tm=None):
    """The (B, M) lnl grid in the kernels' order (`_lnl_tile`,
    ops/fused.py:316-596), floored at float32 min."""
    if free_scale:
        return _fs_tile_plain(d, de, dm, mT, meT, mmT, full_mask=full_mask,
                              dim_prior=dim_prior,
                              ignore_model_err=ignore_model_err,
                              sweeps=sweeps, tm=tm)
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


def lnl_onepass_plain(d, de, dm, mT, meT, mmT, G, **flags):
    """Plain version of `lnl_onepass`: (pdf, lmap, levid), pdf in the
    exp(lnl - lmap) scale."""
    lnl = lnl_tile_plain(d, de, dm, mT, meT, mmT, **flags)
    lmap = lnl.amax(dim=1)
    w = torch.exp(lnl - lmap[:, None])
    return fp32_matmul(w, G), lmap, torch.log(w.sum(dim=1)) + lmap


def lnl_cut_stack_plain(d, de, dm, mT, meT, mmT, G, cut, levid, tie, nkeep,
                        **flags):
    """Plain version of `lnl_cut_stack`: pdf (B, Ngrid)."""
    lnl = lnl_tile_plain(d, de, dm, mT, meT, mmT, **flags)
    is_tie = lnl == tie[:, None]
    rank = torch.cumsum(is_tie.to(torch.int32), dim=1) - 1
    keep = (lnl <= cut[:, None]) | (is_tie & (rank < nkeep[:, None]))
    w = torch.where(keep, torch.exp(lnl - levid[:, None]), 0.0)
    return fp32_matmul(w, G)


def _load_checked(name, smem):
    """The kernel library, after checking the shared memory the kernel
    needs (`smem(lib)` bytes) against the per-block limit."""
    lib = _build.load()
    _check_smem(name, smem(lib))
    return lib


def scale_sweeps(d, de, dm, mT, meT, mmT, *, tm, full_mask=False, ltol=1e-4,
                 max_iter=100):
    """Per object and model group (models [g tm, (g + 1) tm)), the
    sweeps the free-scale fixed point with model errors runs before the
    group's max |delta lnl| is at most max(ltol, 4 eps max A), at most
    `max_iter`.  Returns an int16 (B, ceil(M / tm)) tensor."""
    B, F, M = _check_inputs(d, de, dm, mT, meT, mmT)
    tm, max_iter = int(tm), int(max_iter)
    ng = -(-M // tm) if tm >= 1 else 0
    if tm < 1 or ng > 65535:
        raise ValueError(f"tm={tm}: need 1 <= tm and at most 65535 model "
                         "groups")
    if not 0 <= max_iter <= np.iinfo(np.int16).max:
        raise ValueError(f"max_iter={max_iter} does not fit the int16 table")
    kw = dict(tm=tm, full_mask=full_mask, ltol=ltol, max_iter=max_iter)
    if d.device.type == "cpu":
        return scale_sweeps_plain(d, de, dm, mT, meT, mmT, **kw)
    out = torch.empty((B, ng), dtype=torch.int16, device=d.device)
    if B == 0:
        return out
    lib = _load_checked("scale_sweeps",
                        lambda lib: lib.fz_scale_sweeps_smem(F, tm))
    with torch.cuda.device(d.device):
        rc = lib.fz_scale_sweeps(
            *_ptrs(d, de, dm, mT, meT, mmT, out), B, M, F, tm, ng,
            int(bool(full_mask)), float(ltol), max_iter, _nd_full(F),
            _stream(d.device))
    _check_rc("scale_sweeps", rc)
    scale_sweeps.launches += 1
    return out


def lnl_reduce(d, de, dm, mT, meT, mmT, *, full_mask=False, dim_prior=True,
               ignore_model_err=False, free_scale=False, sweeps=None,
               tm=None):
    """Per object over all models: lmap = max lnl and levid = log sum
    exp(lnl - lmap) + lmap.  Returns (lmap, levid), float32 (B,)."""
    B, F, M = _check_inputs(d, de, dm, mT, meT, mmT)
    flags = _flag_dict(full_mask, dim_prior, ignore_model_err, free_scale,
                       sweeps, tm)
    table = _table_args(B, M, d.device, **flags)
    if d.device.type == "cpu":
        return lnl_reduce_plain(d, de, dm, mT, meT, mmT, **flags)
    lmap = torch.empty(B, dtype=torch.float32, device=d.device)
    levid = torch.empty_like(lmap)
    if B == 0:
        return lmap, levid
    lib = _load_checked("lnl_reduce", lambda lib: lib.fz_lnl_reduce_smem(
        F, table[0] is not None))
    gl = gl_table(F, d.device)
    with torch.cuda.device(d.device):
        rc = _entry(lib, "fz_lnl_reduce", **flags)(
            *_ptrs(d, de, dm, mT, meT, mmT, gl, lmap, levid), B, M, F,
            *_flags(**flags), _nd_full(F), *table, _stream(d.device))
    _check_rc("lnl_reduce", rc)
    lnl_reduce.launches += 1
    return lmap, levid


def lnl_reduce_split(d, de, dm, mT, meT, mmT, split, *, full_mask=False,
                     dim_prior=True, ignore_model_err=False,
                     free_scale=False, sweeps=None, tm=None):
    """Per object, log sum exp(lnl) over the models with lnl > split[b]
    and over those with lnl <= split[b] (NaN joins neither), each summed
    from its own terms, and the count of the first.  Returns (levid_gt,
    levid_le, count_gt), float32 (B,); an empty side gives -inf."""
    B, F, M = _check_inputs(d, de, dm, mT, meT, mmT)
    _check("split", split, (B,), d.device)
    flags = _flag_dict(full_mask, dim_prior, ignore_model_err, free_scale,
                       sweeps, tm)
    table = _table_args(B, M, d.device, **flags)
    if d.device.type == "cpu":
        return lnl_reduce_split_plain(d, de, dm, mT, meT, mmT, split,
                                      **flags)
    gt = torch.empty(B, dtype=torch.float32, device=d.device)
    le = torch.empty_like(gt)
    count = torch.empty_like(gt)
    if B == 0:
        return gt, le, count
    lib = _load_checked("lnl_reduce_split", lambda lib: lib.fz_lnl_reduce_smem(
        F, table[0] is not None))
    gl = gl_table(F, d.device)
    with torch.cuda.device(d.device):
        rc = _entry(lib, "fz_lnl_reduce_split", **flags)(
            *_ptrs(d, de, dm, mT, meT, mmT, gl, split, gt, le, count),
            B, M, F, *_flags(**flags), _nd_full(F), *table,
            _stream(d.device))
    _check_rc("lnl_reduce_split", rc)
    lnl_reduce_split.launches += 1
    return gt, le, count


def lnl_topk(d, de, dm, mT, meT, mmT, *, T, full_mask=False, dim_prior=True,
             ignore_model_err=False, free_scale=False, sweeps=None, tm=None):
    """Per object, the T largest distinct lnl values (descending) and
    their tie counts; unused slots hold float32 min and count 0.
    Returns (vals, cnts), float32 (B, T)."""
    B, F, M = _check_inputs(d, de, dm, mT, meT, mmT)
    T = int(T)
    if T < 1:
        raise ValueError(f"T={T}: need at least one slot")
    flags = _flag_dict(full_mask, dim_prior, ignore_model_err, free_scale,
                       sweeps, tm)
    table = _table_args(B, M, d.device, **flags)
    if d.device.type == "cpu":
        return lnl_topk_plain(d, de, dm, mT, meT, mmT, T=T, **flags)
    vals = torch.empty((B, T), dtype=torch.float32, device=d.device)
    cnts = torch.empty_like(vals)
    if B == 0:
        return vals, cnts
    lib = _load_checked("lnl_topk", lambda lib: lib.fz_lnl_topk_smem(
        F, T, table[0] is not None))
    gl = gl_table(F, d.device)
    with torch.cuda.device(d.device):
        rc = _entry(lib, "fz_lnl_topk", **flags)(
            *_ptrs(d, de, dm, mT, meT, mmT, gl, vals, cnts), B, M, F, T,
            *_flags(**flags), _nd_full(F), *table, _stream(d.device))
    _check_rc("lnl_topk", rc)
    lnl_topk.launches += 1
    return vals, cnts


def _check_stack_inputs(d, G, M, rows):
    if G.ndim != 2 or G.shape[1] < 1:
        raise ValueError("G must be (M, Ngrid) with Ngrid >= 1")
    _check("G", G, (M, G.shape[1]), d.device)
    for name, t in rows.items():
        _check(name, t, (d.shape[0],), d.device)


def _launch_cols(name, fn, d, de, dm, mT, meT, mmT, G, ptrs, sizes, flags,
                 table):
    """Launch a grid-column kernel (stack, cut stack, onepass): `ptrs`
    are the pointers after G, `sizes` the arguments after Ngrid and
    before the flags."""
    B, F = d.shape
    ngrid = G.shape[1]
    lib = _load_checked(name, lambda lib: lib.fz_lnl_stack_smem(F))
    gl = gl_table(F, d.device)
    threads = min(-(-ngrid // 32) * 32, _STACK_MAX_THREADS)
    with torch.cuda.device(d.device):
        rc = _entry(lib, fn, **flags)(
            *_ptrs(d, de, dm, mT, meT, mmT, gl, G, *ptrs), B,
            mT.shape[1], F, ngrid, *sizes, *_flags(**flags), _nd_full(F),
            *table, threads, _stream(d.device))
    _check_rc(name, rc)


def lnl_stack(d, de, dm, mT, meT, mmT, G, lmap, levid, *, log_thr,
              full_mask=False, dim_prior=True, ignore_model_err=False,
              free_scale=False, sweeps=None, tm=None):
    """pdf = sum over models of exp(lnl - levid) * G[m], keeping pairs
    with lnl > float32(log_thr) + lmap (the sum rounded in float32).
    Returns pdf (B, Ngrid), float32, in the exp(lnl - levid) scale."""
    B, F, M = _check_inputs(d, de, dm, mT, meT, mmT)
    _check_stack_inputs(d, G, M, dict(lmap=lmap, levid=levid))
    flags = _flag_dict(full_mask, dim_prior, ignore_model_err, free_scale,
                       sweeps, tm)
    table = _table_args(B, M, d.device, **flags)
    if d.device.type == "cpu":
        return lnl_stack_plain(d, de, dm, mT, meT, mmT, G, lmap, levid,
                               log_thr=log_thr, **flags)
    pdf = torch.empty((B, G.shape[1]), dtype=torch.float32, device=d.device)
    if B == 0:
        return pdf
    _launch_cols("lnl_stack", "fz_lnl_stack", d, de, dm, mT, meT, mmT, G,
                 (lmap, levid, pdf), [float(np.float32(log_thr))], flags,
                 table)
    lnl_stack.launches += 1
    return pdf


def lnl_onepass(d, de, dm, mT, meT, mmT, G, *, full_mask=False,
                dim_prior=True, ignore_model_err=False, free_scale=False,
                sweeps=None, tm=None):
    """No weight threshold, one walk over the models: lmap, levid and
    pdf = sum over models of exp(lnl - lmap) * G[m].  Returns (pdf,
    lmap, levid), float32 (B, Ngrid), (B,), (B,); pdf in the exp(lnl -
    lmap) scale."""
    B, F, M = _check_inputs(d, de, dm, mT, meT, mmT)
    _check_stack_inputs(d, G, M, {})
    flags = _flag_dict(full_mask, dim_prior, ignore_model_err, free_scale,
                       sweeps, tm)
    table = _table_args(B, M, d.device, **flags)
    if d.device.type == "cpu":
        return lnl_onepass_plain(d, de, dm, mT, meT, mmT, G, **flags)
    pdf = torch.empty((B, G.shape[1]), dtype=torch.float32, device=d.device)
    lmap = torch.empty(B, dtype=torch.float32, device=d.device)
    levid = torch.empty_like(lmap)
    if B == 0:
        return pdf, lmap, levid
    _launch_cols("lnl_onepass", "fz_lnl_onepass", d, de, dm, mT, meT, mmT, G,
                 (pdf, lmap, levid), [], flags, table)
    lnl_onepass.launches += 1
    return pdf, lmap, levid


def lnl_cut_stack(d, de, dm, mT, meT, mmT, G, cut, levid, tie, nkeep, *,
                  full_mask=False, dim_prior=True, ignore_model_err=False,
                  free_scale=False, sweeps=None, tm=None):
    """As `lnl_stack`, keeping pairs with lnl <= cut[b] and the first
    nkeep[b] models (in model order) with lnl == tie[b] (see
    `ops.fused.cdf_cut`).  Returns pdf (B, Ngrid), float32, in the
    exp(lnl - levid) scale."""
    B, F, M = _check_inputs(d, de, dm, mT, meT, mmT)
    _check_stack_inputs(d, G, M, dict(cut=cut, levid=levid, tie=tie,
                                      nkeep=nkeep))
    flags = _flag_dict(full_mask, dim_prior, ignore_model_err, free_scale,
                       sweeps, tm)
    table = _table_args(B, M, d.device, **flags)
    if d.device.type == "cpu":
        return lnl_cut_stack_plain(d, de, dm, mT, meT, mmT, G, cut, levid,
                                   tie, nkeep, **flags)
    pdf = torch.empty((B, G.shape[1]), dtype=torch.float32, device=d.device)
    if B == 0:
        return pdf
    _launch_cols("lnl_cut_stack", "fz_lnl_cut_stack", d, de, dm, mT, meT,
                 mmT, G, (cut, levid, tie, nkeep, pdf), [], flags, table)
    lnl_cut_stack.launches += 1
    return pdf


_WRAPPERS = (lnl_reduce, lnl_reduce_split, lnl_stack, lnl_topk,
             lnl_cut_stack, lnl_onepass, scale_sweeps)
for _fn in _WRAPPERS:
    _fn.launches = 0


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts():
    """{wrapper name: launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
