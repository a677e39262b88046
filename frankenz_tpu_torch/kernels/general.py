"""Wrappers and plain versions of the general (masked) lnl kernels.

`lnl_reduce`, `lnl_stack`, `lnl_onepass` and `lnl_cut_stack` replace the
Pallas kernels `_make_reduce_kernel` (frankenz_tpu/ops/fused.py:599),
`_make_stack_kernel` (:634), `_make_onepass_kernel` (:670) and
`_make_cut_stack_kernel` (:779), and `lnl_reduce_topk` the cdf mode's
`_make_reduce_kernel` and `_make_topk_kernel` (:721) in one walk over
the models (lmap, levid and the top-T table from each pair's lnl
computed once; `lnl_topk` launches the same kernel and keeps the table),
with both branches of their shared `_lnl_tile` (:316): fixed scale and
free scale (:325-411, and `_lnl_tile_freescale_me`, :452-596).
`lnl_reduce_split`, the reduce on either side of a per-object value,
serves the bisection that finds a cdf cut the top-T table leaves
undetermined (`ops.fused.cdf_cut_exact`).  `scale_sweeps` counts the
free-scale fixed point's sweeps per (object, model group), the table the
other kernels read under free scale with model errors.  The CUDA
sources, with the design notes, are ``csrc/lnl_general.cu`` (fixed
scale), ``csrc/lnl_freescale.cu`` (free scale), ``csrc/lnl_common.cuh``
(the kernel templates), ``csrc/lnl_table.cu`` (the lnl table's readers)
and ``csrc/lnl_band.cuh`` (`lnl_onepass` and `lnl_cut_stack`).

`lnl_onepass`, `lnl_cut_stack` and `lnl_stack_band` take the models in
band order (`band_sort`, the port of JAX's `_band_sort`, K7): sorted by
the centre of their kernel-matrix support, so each 64-model tile's G rows
are nonzero only in a narrow band of grid columns, and only that band
gets products.  A product is skipped only where G is exactly zero.

The two-pass threshold route (`lnl_reduce`, then `lnl_stack`) computes
each pair's lnl once per call into an lnl table: float32 (B,
`table_width(M)`), row-major, entry [b, j] the lnl of object b and model
j (the columns past M are never written).  `lnl_reduce(..., table=t)`
computes, stores and reduces, except under free scale with model errors,
where `scale_sweeps(..., table=t)` stores each pair's lnl as its fixed
point ends and `lnl_reduce` reads it; `lnl_stack(..., table=t)` reads it
(`lnl_stack_read`), and `lnl_stack_band` reads a table written over the
models in band order (the route's reader off free scale with model
errors).  The values are the recompute route's (the same wrappers
without ``table``, on the same model order) bit for bit, and so are lmap,
levid and the PDF.  `table_rows` cuts a batch into row chunks of at most
`TABLE_BYTES_MAX` bytes of table, and of at most a byte budget when one
is given (`ops.fused` runs the route per chunk, its budget the card's
free memory less a margin).

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
wrapper counts its launches in ``<wrapper>.launches``, and `lnl_reduce`,
`lnl_stack` and `scale_sweeps` those with a table also in
``.table_launches`` (``launch_counts()["<wrapper>_table"]``).

The plain versions compute the (B, M) lnl grid with `lnl_tile_plain`,
in the kernels' order (filters k = 0..F-1, ``iv = 1/var``, ``term =
(mask * r^2) * iv``, the same normalization table), so on the card lnl
agrees with the kernels' bit for bit up to the last ulp of `log`, and
`scale_sweeps_plain`'s table equals the kernel's; the sums run in another
order.  The two table readers' plain versions sum their products tile by
tile (`stack_tiles`, products and sums rounded apart), so the band
reader's plain version equals the dense one's on the same model order
bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.special import gammaln as _sp_gammaln

from ..ops.kde import fp32_matmul
from . import build as _build
from .fullmask import _SMEM_MAX, _STACK_MAX_THREADS, _check

__all__ = ["lnl_tile_plain", "lnl_reduce", "lnl_reduce_plain",
           "lnl_reduce_split", "lnl_reduce_split_plain", "lnl_stack",
           "lnl_stack_plain", "lnl_stack_band", "lnl_stack_band_plain",
           "stack_tiles",
           "lnl_onepass", "lnl_onepass_plain",
           "lnl_topk", "lnl_topk_plain", "lnl_reduce_topk",
           "lnl_reduce_topk_plain", "lnl_cut_stack",
           "lnl_cut_stack_plain", "scale_sweeps", "scale_sweeps_plain",
           "gl_table", "table_width", "table_rows", "TABLE_BYTES_MAX",
           "BandSort", "band_sort", "NEG_INF", "reset_launch_counts",
           "launch_counts"]

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

# The lnl table: rows are padded to the kernels' 64-model tile, so every
# tile of a row is whole and 16-byte aligned for the readers' copies; a
# batch is cut into row chunks of at most TABLE_BYTES_MAX bytes of table.
_TABLE_TILE = 64
# Elements of `stack_tiles`' temporaries at once.
_STACK_TILES_ELEMS = 2 ** 26
TABLE_BYTES_MAX = 16 * 2 ** 30

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


def table_width(nmodel):
    """Columns of the lnl table (its row stride): M rounded up to 64."""
    return -(-int(nmodel) // _TABLE_TILE) * _TABLE_TILE


def table_rows(nobj, nmodel, budget=None):
    """Rows per chunk of the lnl table for a batch of `nobj` objects: the
    fewest chunks of at most `TABLE_BYTES_MAX` bytes (and at most `budget`
    bytes when given), of equal size (the last one shorter), at least one
    row.  Raises MemoryError when `budget` does not hold one row."""
    row = 4 * table_width(nmodel)
    cap = max(1, TABLE_BYTES_MAX // row)
    if budget is not None:
        if budget < row:
            raise MemoryError(f"one row of the lnl table ({row} bytes) does "
                              f"not fit the {int(budget)} bytes free")
        cap = min(cap, int(budget) // row)
    nchunks = max(1, -(-int(nobj) // cap))
    return max(1, -(-int(nobj) // nchunks))


class BandSort(NamedTuple):
    """The models in band order (`band_sort`), as `lnl_onepass`,
    `lnl_cut_stack`, `lnl_stack_band` and the banded `chi2_stack` read
    them.

    perm, inv: int32 (M,): band position -> caller index, and back;
    mT, meT, mmT: float32 (F, M), the model columns in band order (mmT
        None when the sort was given none);
    G: float32 (table_width(M), ldg), the kernel matrix's rows in band
        order, ldg = Ngrid rounded up to 4, zeros past M rows and Ngrid
        columns (16-byte rows for the kernels' copies);
    bands: int32 (ceil(M / 64), 2): each 64-model tile's nonzero columns
        [lo, hi) of G ([0, 0) for a tile of all-zero rows);
    ngrid: Ngrid;
    width: the widest band, its edges rounded out to 4 columns."""
    perm: torch.Tensor
    inv: torch.Tensor
    mT: torch.Tensor
    meT: torch.Tensor
    mmT: torch.Tensor
    G: torch.Tensor
    bands: torch.Tensor
    ngrid: int
    width: int


def band_sort(G, mT, meT, mmT=None):
    """The models in band order (JAX's `_band_sort`,
    frankenz_tpu/ops/fused.py:243-267): a stable sort by lo + hi, the first
    and last nonzero columns of each G row, all-zero rows last.  Returns a
    `BandSort`: the permuted model arrays, the padded G, and each
    64-model tile's exact nonzero band (JAX flags 128-column blocks
    instead).  One argsort and one gather of G; reading `width` is one
    synchronization with the device.  The full-mask pair has no model
    mask: `mmT` None stays None."""
    M, ngrid = G.shape
    dev = G.device
    cols = torch.arange(ngrid, dtype=torch.int32, device=dev)
    nz = G != 0.0
    lo = torch.where(nz, cols, ngrid).amin(dim=1)
    hi = torch.where(nz, cols, -1).amax(dim=1)
    del nz
    key = torch.where(hi >= 0, lo + hi, 2 * ngrid + 1)
    order = torch.argsort(key, stable=True)
    perm = order.to(torch.int32)
    inv = torch.empty_like(perm)
    inv[order] = torch.arange(M, dtype=torch.int32, device=dev)
    mp, ldg = table_width(M), -(-ngrid // 4) * 4
    Gs = torch.zeros((mp, ldg), dtype=torch.float32, device=dev)
    Gs[:M, :ngrid] = G[order]
    ntiles = mp // _TABLE_TILE
    lo_t = torch.full((mp,), ngrid, dtype=torch.int32, device=dev)
    hi_t = torch.zeros((mp,), dtype=torch.int32, device=dev)
    lo_t[:M] = lo[order]
    hi_t[:M] = hi[order] + 1
    lo_t = lo_t.view(ntiles, _TABLE_TILE).amin(dim=1)
    hi_t = hi_t.view(ntiles, _TABLE_TILE).amax(dim=1)
    empty = hi_t == 0
    bands = torch.stack([torch.where(empty, 0, lo_t),
                         torch.where(empty, 0, hi_t)], dim=1).contiguous()
    span = torch.where(empty, 0, ((hi_t + 3) // 4 - lo_t // 4) * 4)
    width = int(span.max()) if ntiles else 0
    return BandSort(perm, inv, *(None if x is None else
                                 x[:, order].contiguous()
                                 for x in (mT, meT, mmT)),
                    Gs, bands, int(ngrid), width)


def _check_table(table, B, M, device):
    """The lnl table of a (B objects, M models) call."""
    if not isinstance(table, torch.Tensor) or table.dtype != torch.float32:
        raise TypeError("table must be a float32 tensor")
    if tuple(table.shape) != (B, table_width(M)) or table.device != device \
            or not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError(f"table must be a contiguous, 16-byte aligned "
                         f"({B}, {table_width(M)}) tensor on {device}")


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


def _sweep_policy(flags):
    """Free scale with model errors: the pair policy with a sweep table,
    whose lnl table `scale_sweeps` writes."""
    return bool(flags["free_scale"]) and not flags["ignore_model_err"]


def _sweep_args(B, M, device, *, free_scale, ignore_model_err, sweeps, tm,
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
                       ltol=1e-4, max_iter=100, table=None, dim_prior=True):
    """Plain version of `scale_sweeps`: the int16 (B, ceil(M / tm))
    table of fixed-point sweeps per (object, model group), as the JAX
    tile's while_loop runs them (ops/fused.py:510-544), the models padded
    to a multiple of tm with the JAX glue's sentinels.  With `table`, as
    the kernel: each pair's scale before its last sweep is kept, and the
    lnl from the pair's final (s_prev, s) goes into table[:, :M]."""
    B, F = d.shape
    M = mT.shape[1]
    real = (mT, meT, mmT)
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
    prev = s
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
        prev = torch.where(upd, s, prev)
        s = torch.where(upd, s_n, s)
        lnl = torch.where(upd, lnl_n, lnl)
        it += 1
        count = torch.where(live, it, count).to(torch.int16)
        done = done | (delta <= thr)
    if table is not None:
        table[:, :M] = _fs_residual_plain(
            d, de2, dm, *real, s[:, :M], prev[:, :M], full_mask=full_mask,
            dim_prior=dim_prior)
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


def _fs_residual_plain(d, de2, dm, mT, meT, mmT, s, prev, *, full_mask,
                       dim_prior):
    """The residual pass with model errors kept (the kernels'
    `residual_lnl`): lnl from each pair's (var(prev), s)."""
    B, F = d.shape
    chi2 = torch.zeros((B, mT.shape[1]), dtype=d.dtype, device=d.device)
    A, ndim, logvar = chi2, chi2, chi2
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


def _fs_tile_plain(d, de, dm, mT, meT, mmT, *, full_mask, dim_prior,
                   ignore_model_err, sweeps, tm, perm):
    """The free-scale (B, M) lnl grid in the kernels' order (`FreePair`
    of csrc/lnl_freescale.cu)."""
    B, F = d.shape
    M = mT.shape[1]
    de2 = de * de
    if not ignore_model_err:
        caller = (torch.arange(M, device=d.device) if perm is None
                  else perm.long())
        count = sweeps.long()[:, caller // int(tm)]
        s = _fs_scale_plain(d, de2, dm, mT, meT, mmT, None, full_mask)
        prev = s
        for i in range(1, int(count.max()) + 1 if count.numel() else 1):
            s_n = _fs_scale_plain(d, de2, dm, mT, meT, mmT, s, full_mask)
            upd = count >= i
            prev = torch.where(upd, s, prev)
            s = torch.where(upd, s_n, s)
        return _fs_residual_plain(d, de2, dm, mT, meT, mmT, s, prev,
                                  full_mask=full_mask, dim_prior=dim_prior)
    zeros = torch.zeros((B, M), dtype=d.dtype, device=d.device)
    chi2, ndim = zeros, zeros
    logvar = torch.zeros((B, 1), dtype=d.dtype, device=d.device)
    # Datum-only variance: the closed form.
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
    chi2 = torch.maximum(chi2, CHI2_NOISE * A)
    return _fs_tail(chi2, ndim, logvar, F, full_mask, dim_prior)


def lnl_tile_plain(d, de, dm, mT, meT, mmT, *, full_mask=False,
                   dim_prior=True, ignore_model_err=False, free_scale=False,
                   sweeps=None, tm=None, perm=None):
    """The (B, M) lnl grid in the kernels' order (`_lnl_tile`,
    ops/fused.py:316-596), floored at float32 min.  `perm`: the caller
    index of each model column (band order), whose sweep group is
    perm // tm."""
    if free_scale:
        return _fs_tile_plain(d, de, dm, mT, meT, mmT, full_mask=full_mask,
                              dim_prior=dim_prior,
                              ignore_model_err=ignore_model_err,
                              sweeps=sweeps, tm=tm, perm=perm)
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


def _reduce_of(lnl):
    """(lmap, levid) of a (B, M) lnl grid."""
    lmap = lnl.amax(dim=1)
    levid = torch.log(torch.exp(lnl - lmap[:, None]).sum(dim=1)) + lmap
    return lmap, levid


def lnl_reduce_plain(d, de, dm, mT, meT, mmT, *, table=None, **flags):
    """Plain version of `lnl_reduce`: (lmap, levid), each (B,).  With
    `table`: the lnl read from it under free scale with model errors,
    else computed and stored into table[:, :M]."""
    M = mT.shape[1]
    if table is not None and _sweep_policy(flags):
        lnl = table[:, :M]
    else:
        lnl = lnl_tile_plain(d, de, dm, mT, meT, mmT, **flags)
        if table is not None:
            table[:, :M] = lnl
    return _reduce_of(lnl)


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


def _topk_of(lnl, T):
    """(vals, cnts), each (B, T): the T largest distinct values of each
    row of a (B, M) lnl grid, descending, with their counts."""
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


def lnl_topk_plain(d, de, dm, mT, meT, mmT, *, T, **flags):
    """Plain version of `lnl_topk`: (vals, cnts), each (B, T)."""
    return _topk_of(lnl_tile_plain(d, de, dm, mT, meT, mmT, **flags), T)


def lnl_reduce_topk_plain(d, de, dm, mT, meT, mmT, *, T, **flags):
    """Plain version of `lnl_reduce_topk`: `lnl_reduce_plain` and
    `lnl_topk_plain` over one lnl grid; (lmap, levid, vals, cnts)."""
    lnl = lnl_tile_plain(d, de, dm, mT, meT, mmT, **flags)
    return (*_reduce_of(lnl), *_topk_of(lnl, T))


def stack_tiles(w, G, bands=None):
    """sum over models m of w[:, m] G[m], in the stack kernels' order of
    tiles: per 64-model tile a partial from +0, one product and one sum
    per model in model order (each rounded on its own), then the partial
    into the total, tile by tile.  With ``bands`` (int32 (tiles, 2), each
    tile's nonzero columns [lo, hi) of G) a tile's products cover only a
    window of the widest band's width around its band, bit for bit the
    dense sum (G is zero outside the bands, and adding +0 changes
    nothing).  The per-entry order is the same at every column, so the
    result does not depend on which columns a product covers."""
    B, M = w.shape
    N = G.shape[1]
    T = -(-M // _TABLE_TILE)
    pdf = torch.zeros((B, N), dtype=w.dtype, device=w.device)
    if T == 0 or B == 0 or N == 0:
        return pdf
    if bands is None:
        lo, width = [0] * T, N
    else:
        los, his = bands[:, 0].tolist(), bands[:, 1].tolist()
        width = max(max(h - l for l, h in zip(los, his)), 0)
        if width == 0:
            return pdf
        lo = [min(l, N - width) if h > l else 0 for l, h in zip(los, his)]
    wt = torch.zeros((B, T * _TABLE_TILE), dtype=w.dtype, device=w.device)
    wt[:, :M] = w
    wt = wt.view(B, T, _TABLE_TILE)
    Gt = torch.zeros((T * _TABLE_TILE, N), dtype=G.dtype, device=G.device)
    Gt[:M] = G
    Gt = Gt.view(T, _TABLE_TILE, N)
    cols = (torch.tensor(lo, device=w.device)[:, None]
            + torch.arange(width, device=w.device))
    step = max(1, _STACK_TILES_ELEMS // (B * width))
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        Gw = torch.gather(Gt[t0:t1], 2,
                          cols[t0:t1, None, :].expand(-1, _TABLE_TILE, -1))
        part = torch.zeros((t1 - t0, B, width), dtype=w.dtype,
                           device=w.device)
        for j in range(_TABLE_TILE):
            part = part + wt[:, t0:t1, j].T[:, :, None] * Gw[:, j, None, :]
        for i in range(t1 - t0):
            pdf[:, lo[t0 + i]:lo[t0 + i] + width] += part[i]
    return pdf


def lnl_stack_plain(d, de, dm, mT, meT, mmT, G, lmap, levid, *, log_thr,
                    table=None, **flags):
    """Plain version of `lnl_stack`: pdf (B, Ngrid); the lnl read from
    `table` when given."""
    lnl = (lnl_tile_plain(d, de, dm, mT, meT, mmT, **flags) if table is None
           else table[:, :mT.shape[1]])
    return stack_tiles(_kept_weights(lnl, lmap, levid, log_thr), G)


def _kept_weights(lnl, lmap, levid, log_thr):
    """exp(lnl - levid) where lnl > float32(log_thr) + lmap, else 0."""
    thr = lmap + float(np.float32(log_thr))
    return torch.where(lnl > thr[:, None], torch.exp(lnl - levid[:, None]),
                       0.0)


def lnl_stack_band_plain(table, bs, lmap, levid, *, log_thr):
    """Plain version of `lnl_stack_band`: pdf (B, Ngrid), tile by tile
    over the bands (`stack_tiles`)."""
    M = bs.perm.shape[0]
    w = _kept_weights(table[:, :M], lmap, levid, log_thr)
    return stack_tiles(w, bs.G[:M, :bs.ngrid], bs.bands)


def _band_lnl(d, de, dm, bs, flags):
    """The (B, M) lnl grid of the models in band order."""
    return lnl_tile_plain(d, de, dm, bs.mT, bs.meT, bs.mmT, perm=bs.perm,
                          **flags)


def _band_product(w, bs):
    """sum over models of w[:, m] G[m, :], in band order: each 64-model
    tile's product over its band [lo, hi) (G is zero outside it) added to
    the running total, tile by tile."""
    B, M = w.shape
    pdf = torch.zeros((B, bs.ngrid), dtype=w.dtype, device=w.device)
    for t, (lo, hi) in enumerate(bs.bands.tolist()):
        if hi > lo:
            m0, m1 = t * _TABLE_TILE, min((t + 1) * _TABLE_TILE, M)
            pdf[:, lo:hi] += fp32_matmul(w[:, m0:m1], bs.G[m0:m1, lo:hi])
    return pdf


def lnl_onepass_plain(d, de, dm, bs, **flags):
    """Plain version of `lnl_onepass`: (pdf, lmap, levid), pdf in the
    exp(lnl - lmap) scale; `bs` the models in band order."""
    lnl = _band_lnl(d, de, dm, bs, flags)
    lmap = lnl.amax(dim=1)
    w = torch.exp(lnl - lmap[:, None])
    return _band_product(w, bs), lmap, torch.log(w.sum(dim=1)) + lmap


def lnl_cut_stack_plain(d, de, dm, bs, cut, levid, tie, nkeep, **flags):
    """Plain version of `lnl_cut_stack`: pdf (B, Ngrid); `bs` the models
    in band order.  A straddling tie group keeps its first nkeep members
    in the caller's order."""
    lnl = _band_lnl(d, de, dm, bs, flags)
    is_tie = lnl == tie[:, None]
    rank = torch.cumsum(is_tie[:, bs.inv.long()].to(torch.int32), dim=1) - 1
    first = (rank < nkeep[:, None])[:, bs.perm.long()]
    keep = (lnl <= cut[:, None]) | (is_tie & first)
    w = torch.where(keep, torch.exp(lnl - levid[:, None]), 0.0)
    return _band_product(w, bs)


def _load_checked(name, smem):
    """The kernel library, after checking the shared memory the kernel
    needs (`smem(lib)` bytes) against the per-block limit."""
    lib = _build.load()
    _check_smem(name, smem(lib))
    return lib


def scale_sweeps(d, de, dm, mT, meT, mmT, *, tm, full_mask=False, ltol=1e-4,
                 max_iter=100, table=None, dim_prior=True):
    """Per object and model group (models [g tm, (g + 1) tm)), the
    sweeps the free-scale fixed point with model errors runs before the
    group's max |delta lnl| is at most max(ltol, 4 eps max A), at most
    `max_iter`.  Returns an int16 (B, ceil(M / tm)) tensor.

    With `table` ((B, table_width(M)) float32), also each pair's lnl
    under `dim_prior` (the Normal likelihood when False) from the state
    its fixed point ends in: the lnl table of the two-pass threshold
    route, equal to the free-scale `lnl_tile_plain` over this sweep
    table."""
    B, F, M = _check_inputs(d, de, dm, mT, meT, mmT)
    tm, max_iter = int(tm), int(max_iter)
    ng = -(-M // tm) if tm >= 1 else 0
    if tm < 1 or ng > 65535:
        raise ValueError(f"tm={tm}: need 1 <= tm and at most 65535 model "
                         "groups")
    if not 0 <= max_iter <= np.iinfo(np.int16).max:
        raise ValueError(f"max_iter={max_iter} does not fit the int16 table")
    if table is not None:
        _check_table(table, B, M, d.device)
    kw = dict(tm=tm, full_mask=full_mask, ltol=ltol, max_iter=max_iter)
    if d.device.type == "cpu":
        return scale_sweeps_plain(d, de, dm, mT, meT, mmT, table=table,
                                  dim_prior=dim_prior, **kw)
    out = torch.empty((B, ng), dtype=torch.int16, device=d.device)
    if B == 0:
        return out
    lib = _load_checked("scale_sweeps", lambda lib: lib.fz_scale_sweeps_smem(
        F, tm, int(bool(full_mask)), int(table is not None)))
    gl = gl_table(F, d.device)
    with torch.cuda.device(d.device):
        rc = lib.fz_scale_sweeps(
            *_ptrs(d, de, dm, mT, meT, mmT, gl, out),
            None if table is None else table.data_ptr(), table_width(M), B,
            M, F, tm, ng, int(bool(full_mask)), int(bool(dim_prior)),
            float(ltol), max_iter, _nd_full(F), _stream(d.device))
    _check_rc("scale_sweeps", rc)
    scale_sweeps.launches += 1
    scale_sweeps.table_launches += table is not None
    return out


def lnl_reduce(d, de, dm, mT, meT, mmT, *, full_mask=False, dim_prior=True,
               ignore_model_err=False, free_scale=False, sweeps=None,
               tm=None, table=None):
    """Per object over all models: lmap = max lnl and levid = log sum
    exp(lnl - lmap) + lmap.  Returns (lmap, levid), float32 (B,).

    With `table` ((B, table_width(M)) float32), the table route: under
    free scale with model errors the lnl is read from the table, which
    `scale_sweeps(..., table=)` wrote (no likelihood is computed);
    otherwise each pair's lnl is computed, stored into the table and
    reduced.  Either way the result is the recompute route's bit for
    bit."""
    B, F, M = _check_inputs(d, de, dm, mT, meT, mmT)
    flags = _flag_dict(full_mask, dim_prior, ignore_model_err, free_scale,
                       sweeps, tm)
    sweep = _sweep_args(B, M, d.device, **flags)
    if table is not None:
        _check_table(table, B, M, d.device)
    if d.device.type == "cpu":
        return lnl_reduce_plain(d, de, dm, mT, meT, mmT, table=table,
                                **flags)
    lmap = torch.empty(B, dtype=torch.float32, device=d.device)
    levid = torch.empty_like(lmap)
    if B == 0:
        return lmap, levid
    stream = _stream(d.device)
    with torch.cuda.device(d.device):
        if table is not None and _sweep_policy(flags):
            rc = _build.load().fz_lnl_reduce_read(
                table.data_ptr(), table_width(M), *_ptrs(lmap, levid), B, M,
                stream)
        elif table is not None:
            lib = _load_checked("lnl_reduce",
                                lambda lib: lib.fz_lnl_reduce_store_smem(F))
            rc = _entry(lib, "fz_lnl_reduce_store", **flags)(
                *_ptrs(d, de, dm, mT, meT, mmT, gl_table(F, d.device), lmap,
                       levid, table), table_width(M), B, M, F,
                *_flags(**flags), _nd_full(F), stream)
        else:
            lib = _load_checked("lnl_reduce",
                                lambda lib: lib.fz_lnl_reduce_smem(
                                    F, sweep[0] is not None))
            rc = _entry(lib, "fz_lnl_reduce", **flags)(
                *_ptrs(d, de, dm, mT, meT, mmT, gl_table(F, d.device), lmap,
                       levid), B, M, F, *_flags(**flags), _nd_full(F),
                *sweep, stream)
    _check_rc("lnl_reduce", rc)
    lnl_reduce.launches += 1
    lnl_reduce.table_launches += table is not None
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
    sweep = _sweep_args(B, M, d.device, **flags)
    if d.device.type == "cpu":
        return lnl_reduce_split_plain(d, de, dm, mT, meT, mmT, split,
                                      **flags)
    gt = torch.empty(B, dtype=torch.float32, device=d.device)
    le = torch.empty_like(gt)
    count = torch.empty_like(gt)
    if B == 0:
        return gt, le, count
    lib = _load_checked("lnl_reduce_split", lambda lib: lib.fz_lnl_reduce_smem(
        F, sweep[0] is not None))
    gl = gl_table(F, d.device)
    with torch.cuda.device(d.device):
        rc = _entry(lib, "fz_lnl_reduce_split", **flags)(
            *_ptrs(d, de, dm, mT, meT, mmT, gl, split, gt, le, count),
            B, M, F, *_flags(**flags), _nd_full(F), *sweep,
            _stream(d.device))
    _check_rc("lnl_reduce_split", rc)
    lnl_reduce_split.launches += 1
    return gt, le, count


def _reduce_topk_launch(d, de, dm, mT, meT, mmT, T, flags):
    """Check the inputs and T; on a CPU tensor return None, on a CUDA
    tensor launch `lnl_reduce_topk`'s kernel and return (lmap, levid,
    vals, cnts)."""
    B, F, M = _check_inputs(d, de, dm, mT, meT, mmT)
    if T < 1:
        raise ValueError(f"T={T}: need at least one slot")
    sweep = _sweep_args(B, M, d.device, **flags)
    if d.device.type == "cpu":
        return None
    lmap = torch.empty(B, dtype=torch.float32, device=d.device)
    levid = torch.empty_like(lmap)
    vals = torch.empty((B, T), dtype=torch.float32, device=d.device)
    cnts = torch.empty_like(vals)
    if B == 0:
        return lmap, levid, vals, cnts
    lib = _load_checked("lnl_reduce_topk",
                        lambda lib: lib.fz_lnl_reduce_topk_smem(
                            F, T, sweep[0] is not None))
    gl = gl_table(F, d.device)
    with torch.cuda.device(d.device):
        rc = _entry(lib, "fz_lnl_reduce_topk", **flags)(
            *_ptrs(d, de, dm, mT, meT, mmT, gl, lmap, levid, vals, cnts), B,
            M, F, T, *_flags(**flags), _nd_full(F), *sweep, _stream(d.device))
    _check_rc("lnl_reduce_topk", rc)
    return lmap, levid, vals, cnts


def lnl_reduce_topk(d, de, dm, mT, meT, mmT, *, T, full_mask=False,
                    dim_prior=True, ignore_model_err=False, free_scale=False,
                    sweeps=None, tm=None):
    """The cdf mode's reduce and top-T in one walk over the models:
    `lnl_reduce`'s (lmap, levid), bit for bit, and `lnl_topk`'s (vals,
    cnts).  Returns (lmap, levid, vals, cnts), float32 (B,), (B,), (B,
    T), (B, T)."""
    T = int(T)
    flags = _flag_dict(full_mask, dim_prior, ignore_model_err, free_scale,
                       sweeps, tm)
    out = _reduce_topk_launch(d, de, dm, mT, meT, mmT, T, flags)
    if out is None:
        return lnl_reduce_topk_plain(d, de, dm, mT, meT, mmT, T=T, **flags)
    lnl_reduce_topk.launches += d.shape[0] > 0
    return out


def lnl_topk(d, de, dm, mT, meT, mmT, *, T, full_mask=False, dim_prior=True,
             ignore_model_err=False, free_scale=False, sweeps=None, tm=None):
    """Per object, the T largest distinct lnl values (descending) and
    their tie counts; unused slots hold float32 min and count 0.
    Returns (vals, cnts), float32 (B, T).  On the card it launches
    `lnl_reduce_topk`'s kernel and drops lmap and levid.  No route calls
    it (the cdf route calls `lnl_reduce_topk`); it stays for the tests
    written against it, and its counter counts that kernel's launches
    made here."""
    T = int(T)
    flags = _flag_dict(full_mask, dim_prior, ignore_model_err, free_scale,
                       sweeps, tm)
    out = _reduce_topk_launch(d, de, dm, mT, meT, mmT, T, flags)
    if out is None:
        return lnl_topk_plain(d, de, dm, mT, meT, mmT, T=T, **flags)
    lnl_topk.launches += d.shape[0] > 0
    return out[2:]


def _check_stack_inputs(d, G, M, rows):
    if G.ndim != 2 or G.shape[1] < 1:
        raise ValueError("G must be (M, Ngrid) with Ngrid >= 1")
    _check("G", G, (M, G.shape[1]), d.device)
    for name, t in rows.items():
        _check(name, t, (d.shape[0],), d.device)


def _col_threads(ngrid):
    """Threads of the stack kernels: one a grid column, up to
    _STACK_MAX_THREADS (more columns take more blocks)."""
    return min(-(-ngrid // 32) * 32, _STACK_MAX_THREADS)


def lnl_stack(d, de, dm, mT, meT, mmT, G, lmap, levid, *, log_thr,
              full_mask=False, dim_prior=True, ignore_model_err=False,
              free_scale=False, sweeps=None, tm=None, table=None):
    """pdf = sum over models of exp(lnl - levid) * G[m], keeping pairs
    with lnl > float32(log_thr) + lmap (the sum rounded in float32).
    Returns pdf (B, Ngrid), float32, in the exp(lnl - levid) scale.  With
    `table`, the lnl is read from it (the table route; `lnl_reduce`
    wrote it, or `scale_sweeps`) on every instantiation, bit for bit the
    recompute route's PDF."""
    B, F, M = _check_inputs(d, de, dm, mT, meT, mmT)
    _check_stack_inputs(d, G, M, dict(lmap=lmap, levid=levid))
    flags = _flag_dict(full_mask, dim_prior, ignore_model_err, free_scale,
                       sweeps, tm)
    sweep = _sweep_args(B, M, d.device, **flags)
    if table is not None:
        _check_table(table, B, M, d.device)
    if d.device.type == "cpu":
        return lnl_stack_plain(d, de, dm, mT, meT, mmT, G, lmap, levid,
                               log_thr=log_thr, table=table, **flags)
    pdf = torch.empty((B, G.shape[1]), dtype=torch.float32, device=d.device)
    if B == 0:
        return pdf
    log_thr = float(np.float32(log_thr))
    ngrid = G.shape[1]
    with torch.cuda.device(d.device):
        if table is None:
            lib = _load_checked("lnl_stack",
                                lambda lib: lib.fz_lnl_stack_smem(F))
            rc = _entry(lib, "fz_lnl_stack", **flags)(
                *_ptrs(d, de, dm, mT, meT, mmT, gl_table(F, d.device), G,
                       lmap, levid, pdf), B, M, F, ngrid, log_thr,
                *_flags(**flags), _nd_full(F), *sweep, _col_threads(ngrid),
                _stream(d.device))
        else:
            rc = _build.load().fz_lnl_stack_read(
                table.data_ptr(), table_width(M), *_ptrs(G, lmap, levid, pdf),
                B, M, ngrid, log_thr, _col_threads(ngrid), _stream(d.device))
    _check_rc("lnl_stack", rc)
    lnl_stack.launches += 1
    lnl_stack.table_launches += table is not None
    return pdf


def lnl_stack_band(table, bs, lmap, levid, *, log_thr):
    """The table route's stack over the models in band order: pdf = sum
    over models of exp(lnl - levid) * G[m], keeping pairs with lnl >
    float32(log_thr) + lmap, where `table` holds the lnl of the models in
    band order (`lnl_reduce(..., table=)` on bs.mT, bs.meT, bs.mmT) and
    `bs` is their `band_sort`; a 64-model tile multiplies only its band of
    G.  Returns pdf (B, Ngrid), float32, in the exp(lnl - levid) scale: bit
    for bit `lnl_stack` on the band-ordered model arrays and G."""
    if not isinstance(table, torch.Tensor) or table.ndim != 2:
        raise ValueError("table must be a (B, table_width(M)) tensor")
    B, dev = table.shape[0], table.device
    M = _check_band(bs, None, dev)
    _check_table(table, B, M, dev)
    for name, t in (("lmap", lmap), ("levid", levid)):
        _check(name, t, (B,), dev)
    if dev.type == "cpu":
        return lnl_stack_band_plain(table, bs, lmap, levid, log_thr=log_thr)
    pdf = torch.empty((B, bs.ngrid), dtype=torch.float32, device=dev)
    if B == 0:
        return pdf
    with torch.cuda.device(dev):
        rc = _build.load().fz_lnl_stack_band(
            table.data_ptr(), table_width(M), bs.G.data_ptr(), bs.G.shape[1],
            bs.bands.data_ptr(), int(bs.width), lmap.data_ptr(),
            levid.data_ptr(), pdf.data_ptr(), B, M, bs.ngrid,
            float(np.float32(log_thr)), _stream(dev))
    _check_rc("lnl_stack_band", rc)
    lnl_stack_band.launches += 1
    return pdf


def _check_band(bs, F, device):
    """The models in band order (`band_sort`) for F filters on `device`
    (F None: the model arrays are not read); returns M."""
    if not isinstance(bs, BandSort):
        raise TypeError("bs must be the BandSort of `band_sort`")
    M = bs.perm.shape[0] if bs.perm.ndim == 1 else -1
    if M < 1:
        raise ValueError("need at least one model")
    if F is not None:
        for name, t in (("mT", bs.mT), ("meT", bs.meT), ("mmT", bs.mmT)):
            _check(name, t, (F, M), device)
    _check("G", bs.G, (table_width(M), -(-int(bs.ngrid) // 4) * 4), device)
    for name, t, shape in (("perm", bs.perm, (M,)), ("inv", bs.inv, (M,)),
                           ("bands", bs.bands,
                            (table_width(M) // _TABLE_TILE, 2))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 {shape} "
                             f"tensor on {device}")
    if bs.G.data_ptr() % 16:
        raise ValueError("G must be 16-byte aligned")
    return M


def _launch_band(name, fn, d, de, dm, bs, ptrs, flags, sweep):
    """Launch a band kernel: `ptrs` the pointers after G (perm onward)."""
    B, F = d.shape
    M = bs.perm.shape[0]
    with torch.cuda.device(d.device):
        rc = _entry(_build.load(), fn, **flags)(
            *_ptrs(d, de, dm, bs.mT, bs.meT, bs.mmT, gl_table(F, d.device),
                   bs.G, *ptrs), B, M, F, bs.ngrid, bs.G.shape[1],
            int(bs.width), *_flags(**flags), _nd_full(F), *sweep,
            _stream(d.device))
    _check_rc(name, rc)


def lnl_onepass(d, de, dm, bs, *, full_mask=False, dim_prior=True,
                ignore_model_err=False, free_scale=False, sweeps=None,
                tm=None):
    """No weight threshold, one walk over the models in band order (`bs`,
    from `band_sort`): lmap, levid and pdf = sum over models of exp(lnl -
    lmap) * G[m].  Returns (pdf, lmap, levid), float32 (B, Ngrid), (B,),
    (B,); pdf in the exp(lnl - lmap) scale.  Under free scale with model
    errors `sweeps` is in the caller's order (model j of the band order
    runs sweeps[b, perm[j] // tm])."""
    if d.ndim != 2:
        raise ValueError("d must be (B, F)")
    B, F = d.shape
    M = _check_band(bs, F, d.device)
    _check_inputs(d, de, dm, bs.mT, bs.meT, bs.mmT)
    flags = _flag_dict(full_mask, dim_prior, ignore_model_err, free_scale,
                       sweeps, tm)
    sweep = _sweep_args(B, M, d.device, **flags)
    if d.device.type == "cpu":
        return lnl_onepass_plain(d, de, dm, bs, **flags)
    pdf = torch.empty((B, bs.ngrid), dtype=torch.float32, device=d.device)
    lmap = torch.empty(B, dtype=torch.float32, device=d.device)
    levid = torch.empty_like(lmap)
    if B == 0:
        return pdf, lmap, levid
    _launch_band("lnl_onepass", "fz_lnl_onepass", d, de, dm, bs,
                 (bs.perm, bs.bands, pdf, lmap, levid), flags, sweep)
    lnl_onepass.launches += 1
    return pdf, lmap, levid


def lnl_cut_stack(d, de, dm, bs, cut, levid, tie, nkeep, *, full_mask=False,
                  dim_prior=True, ignore_model_err=False, free_scale=False,
                  sweeps=None, tm=None):
    """As `lnl_stack` over the models in band order (`bs`, from
    `band_sort`), keeping pairs with lnl <= cut[b] and the first nkeep[b]
    models in the caller's order with lnl == tie[b] (see
    `ops.fused.cdf_cut`).  Returns pdf (B, Ngrid), float32, in the
    exp(lnl - levid) scale."""
    if d.ndim != 2:
        raise ValueError("d must be (B, F)")
    B, F = d.shape
    M = _check_band(bs, F, d.device)
    _check_inputs(d, de, dm, bs.mT, bs.meT, bs.mmT)
    for name, t in (("cut", cut), ("levid", levid), ("tie", tie),
                    ("nkeep", nkeep)):
        _check(name, t, (B,), d.device)
    flags = _flag_dict(full_mask, dim_prior, ignore_model_err, free_scale,
                       sweeps, tm)
    sweep = _sweep_args(B, M, d.device, **flags)
    if d.device.type == "cpu":
        return lnl_cut_stack_plain(d, de, dm, bs, cut, levid, tie, nkeep,
                                   **flags)
    pdf = torch.empty((B, bs.ngrid), dtype=torch.float32, device=d.device)
    if B == 0:
        return pdf
    _launch_band("lnl_cut_stack", "fz_lnl_cut_stack", d, de, dm, bs,
                 (bs.perm, bs.inv, bs.bands, cut, levid, tie, nkeep, pdf),
                 flags, sweep)
    lnl_cut_stack.launches += 1
    return pdf


_WRAPPERS = (lnl_reduce, lnl_reduce_split, lnl_stack, lnl_stack_band,
             lnl_topk, lnl_reduce_topk, lnl_cut_stack, lnl_onepass,
             scale_sweeps)
# The wrappers with a table route also count its launches apart.
_TABLE_WRAPPERS = (lnl_reduce, lnl_stack, scale_sweeps)


def reset_launch_counts():
    """Set every kernel wrapper's launch counts to 0."""
    for fn in _WRAPPERS:
        fn.launches = 0
    for fn in _TABLE_WRAPPERS:
        fn.table_launches = 0


reset_launch_counts()


def launch_counts():
    """{wrapper name: launches since the last reset}, and
    {"<wrapper>_table": those with an lnl table} for `lnl_reduce`,
    `lnl_stack` and `scale_sweeps`."""
    return {**{fn.__name__: fn.launches for fn in _WRAPPERS},
            **{fn.__name__ + "_table": fn.table_launches
               for fn in _TABLE_WRAPPERS}}
