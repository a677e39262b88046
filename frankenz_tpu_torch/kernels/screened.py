"""Wrappers and plain versions of the screened full-mask kernels (K2).

`screen_bound_seed` (the seed stage), `chi2_brackets_screened` (pass A)
and `chi2_stack_screened` (pass B) replace the Pallas kernels
`_make_seed_kernel` (frankenz_tpu/ops/fused.py:1249) with the glue that
feeds it (`_screen_prep`'s subtile bounds and anchor seed, the home
tiles), `_make_chi2max_screened_kernel` (:1272) and
`_make_chi2stack_screened_kernel` (:1308); the CUDA sources, with the
design notes and the two skip proofs, are in ``csrc/chi2_screened.cu``,
and the glue that sorts, boxes and cuts is ``ops/screen.py``.  The seed
stage runs one CTA per object block: its bounds, block minima and home
tile, then the anchors' and the home tile's pairs.  Passes A and B
compact each object block's admitted subtiles first, then stream them in
chunks of models (pass A 128 to 8 warps, pass B up to 256 to 16) through
a two-slot shared-memory ring filled by TMA bulk copies, a lane per
object row; pass B's stack dot walks each row's kept models only.

Every input is float32 (int32 for the index tables), contiguous, and on
one device; objects and models are already in the glue's sorted order:

* ``d``, ``de``: (B, F) data and errors; objects come in blocks of ``tb``
  consecutive rows (`TB` on the card, the kernels' block);
* ``mT``, ``meT``: (F, M) model photometry and errors, pre-transposed;
  models come in subtiles of ``sm``, S = ceil(M / sm), the last ragged;
* ``blo``, ``bhi``, ``memax``: (F, S) each subtile's photometric box and
  largest model error (the seed stage);
* ``bounds``: (S, B) lower bounds of each subtile's chi^2 per object;
* ``visit``: (nb, S) int32, each block's subtiles in visit order (pass B);
* ``cut_uf``, ``cut_dot``, ``cut_abs``: (B,) chi^2 cuts, ``ph``: (B,)
  int32 visit positions (pass B; ``ph`` / ``cut_abs`` only with
  absorption).

On a CPU tensor a wrapper runs its plain PyTorch version; on a CUDA
tensor it launches the kernel or raises: there is no fallback.  Each
wrapper counts its launches in ``<wrapper>.launches``.  The kernels
stage model chunks with 16-byte bulk copies (TMA): on the card passes A
and B take `sm`, the seed stage `tm`, a multiple of 4, and when M is not
a multiple of 4 the wrapper hands the kernel zero-padded (F, ceil4(M))
copies of ``mT`` and ``meT`` (`_bulk_rows`; the plain versions never see
them).

The seed stage's plain version is the glue's torch composition itself,
and the kernel computes each of its outputs bit for bit.  The other
plain versions run the kernels' gates, block grouping and visit order,
vectorised across blocks (pass B: one step per visit position, each
block's subtile gathered), and the kernels' per-pair arithmetic order, so
on the card chi^2 and the brackets agree bit for bit.  Their
subtile sums and stack products are torch reductions and matmuls, whose
order differs from the kernels'.  A skipped subtile is one whose
partials are not added, as in the kernels: so the plain screened call
equals the plain call with every gate open bit for bit, as the kernels
do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kde import fp32_matmul
from . import build as _build
from .fullmask import _bulk_rows, _check, _check_pair_inputs, _weights_plain
from .general import _check_rc, _load_checked, _stream

__all__ = ["screen_bound_seed", "screen_bound_seed_plain",
           "subtile_bounds_plain", "anchor_seed_plain",
           "chi2_brackets_screened", "chi2_brackets_screened_plain",
           "chi2_stack_screened", "chi2_stack_screened_plain", "expf_probe",
           "TB", "N_ANCHOR", "reset_launch_counts", "launch_counts"]

# Objects per object block of the kernels (csrc/chi2_screened.cu kTB).
TB = 32
# Anchor models of the seed, spread evenly through the sorted order.
N_ANCHOR = 256


def nblocks(B, tb):
    """Object blocks of `tb` rows over B objects (the last ragged)."""
    return -(-int(B) // int(tb))


def block_any(mask, tb):
    """(..., B) bool -> (..., nb): any over each block's rows."""
    B = mask.shape[-1]
    nb = nblocks(B, tb)
    pad = nb * tb - B
    if pad:
        mask = torch.nn.functional.pad(mask, (0, pad), value=False)
    return mask.reshape(*mask.shape[:-1], nb, tb).any(dim=-1)


def _rows(x, tb, fill):
    """(B, ...) -> (nb, tb, ...), padded with `fill`."""
    B = x.shape[0]
    nb = nblocks(B, tb)
    if nb * tb != B:
        pad = x.new_full((nb * tb - B, *x.shape[1:]), fill)
        x = torch.cat([x, pad])
    return x.reshape(nb, tb, *x.shape[1:])


def _chi2_blocks(d3, de3, mg, meg, ignore_model_err):
    """chi^2 (nb, tb, n) of rows d3 / de3 (nb, tb, F) against each
    block's models mg / meg (F, nb or 1, n), in the kernels' order:
    per filter var = de*de (+ me*me), term = (r*r)/var, k = 0..F-1."""
    de2 = de3 * de3
    chi2 = torch.zeros((*d3.shape[:2], mg.shape[-1]), dtype=d3.dtype,
                       device=d3.device)
    for k in range(d3.shape[-1]):
        mk = mg[k][:, None, :]
        if ignore_model_err:
            var = de2[..., k:k + 1]
        else:
            mek = meg[k][:, None, :]
            var = de2[..., k:k + 1] + mek * mek
        r = d3[..., k:k + 1] - mk
        chi2 = chi2 + (r * r) / var
    return chi2


def _gather_models(mT, meT, idx):
    """Models idx (nb, n) (clamped into range) -> (F, nb, n) each."""
    safe = idx.clamp_max(mT.shape[1] - 1)
    return mT[:, safe], meT[:, safe]


def subtile_bounds_plain(d, de, blo, bhi, memax, ignore_model_err):
    """(S, B) lower bounds of every chi^2 of each object in each model
    subtile: the distance to the subtile's box (blo, bhi) over its largest
    variance, filter by filter, deflated by 1e-4 (`_screen_prep`,
    ops/fused.py:1153-1168)."""
    bound = None
    for k in range(blo.shape[0]):
        dk = d[None, :, k]                                       # (1, B)
        gap = torch.clamp_min(torch.maximum(blo[k][:, None] - dk,
                                            dk - bhi[k][:, None]), 0.0)
        v = de[None, :, k] * de[None, :, k]
        if not ignore_model_err:
            v = v + memax[k][:, None] * memax[k][:, None]
        t = gap * gap / v
        bound = t if bound is None else bound + t
    if bound is None:
        return torch.zeros((blo.shape[1], d.shape[0]), dtype=d.dtype,
                           device=d.device)
    return bound * (1.0 - 1e-4)


def anchor_seed_plain(d, de, mT, meT, c0, ignore_model_err,
                      n_anchor=N_ANCHOR):
    """(B,) the least chi^2 >= c0 (1 + 1e-3) over min(n_anchor, M) anchor
    models spread evenly through the (sorted) models, inflated by 1e-4;
    +inf where none qualifies (`anchor_min`, ops/fused.py:1182-1203)."""
    M = mT.shape[1]
    A = min(int(n_anchor), int(M))
    if A == 0:
        return torch.full_like(d[:, 0], torch.inf)
    aidx = torch.arange(A, device=d.device) * (M // A)
    am, ame = mT[:, aidx], meT[:, aidx]
    chi2a = None
    for k in range(d.shape[1]):
        va = de[:, k:k + 1] * de[:, k:k + 1]
        if not ignore_model_err:
            va = va + ame[k][None, :] * ame[k][None, :]
        r = d[:, k:k + 1] - am[k][None, :]
        t = r * r / va
        chi2a = t if chi2a is None else chi2a + t
    qual = chi2a >= c0 * (1.0 + 1e-3)
    return torch.where(qual, chi2a, torch.inf).amin(dim=1) * (1.0 + 1e-4)


def _home_seed_plain(d, de, mT, meT, start, *, width, c0, tb,
                     ignore_model_err):
    """Per object, min{chi2 >= c0} over the `width` models from
    start[block] (clipped at M), times (1 + 1e-6); (B,)."""
    B = d.shape[0]
    M = mT.shape[1]
    idx = (start.long()[:, None]
           + torch.arange(int(width), device=d.device)[None, :])
    mg, meg = _gather_models(mT, meT, idx)
    chi2 = _chi2_blocks(_rows(d, tb, 0.0), _rows(de, tb, 1.0), mg, meg,
                        ignore_model_err)
    keep = (idx < M)[:, None, :] & (chi2 >= c0)
    hi = torch.where(keep, chi2, torch.inf).amin(dim=2).reshape(-1)[:B]
    return hi * (1.0 + 1e-6)


def screen_bound_seed_plain(d, de, mT, meT, blo, bhi, memax, *, sm, tm, c0,
                            tb=TB, ignore_model_err=False,
                            n_anchor=N_ANCHOR):
    """Plain version of `screen_bound_seed`: (bounds (S, B), bmin (S, nb),
    start (nb,) int32, seed (B,)), the glue's torch composition."""
    B = d.shape[0]
    bounds = subtile_bounds_plain(d, de, blo, bhi, memax, ignore_model_err)
    S = bounds.shape[0]
    nb = nblocks(B, tb)
    bmin = torch.nn.functional.pad(bounds, (0, nb * tb - B),
                                   value=torch.inf)
    bmin = bmin.reshape(S, nb, tb).amin(dim=2)                    # (S, nb)
    start = ((torch.argmin(bmin, dim=0) // (int(tm) // int(sm)))
             * int(tm)).to(torch.int32).contiguous()
    home = _home_seed_plain(d, de, mT, meT, start, width=tm, c0=c0, tb=tb,
                            ignore_model_err=ignore_model_err)
    anchor = anchor_seed_plain(d, de, mT, meT, c0, ignore_model_err,
                               n_anchor)
    return bounds, bmin, start, torch.minimum(anchor, home)


def chi2_brackets_screened_plain(d, de, mT, meT, bounds, seed, *, c0, sm,
                                 tb=TB, ignore_model_err=False):
    """Plain version of `chi2_brackets_screened`: (below, above), (B,)."""
    B = d.shape[0]
    M = mT.shape[1]
    blk = torch.arange(B, device=d.device) // tb
    run = block_any(bounds <= seed[None, :], tb)[:, blk]     # (S, B)
    below = torch.full((B,), -1.0, dtype=d.dtype, device=d.device)
    above = torch.full_like(below, torch.inf)
    d3, de3 = d[None], de[None]
    for s in range(bounds.shape[0]):
        rs = run[s]
        if not bool(rs.any()):
            continue
        sl = slice(s * sm, min(s * sm + sm, M))
        chi2 = _chi2_blocks(d3, de3, mT[:, None, sl], meT[:, None, sl],
                            ignore_model_err)[0]
        lo = torch.where(chi2 < c0, chi2, -1.0).amax(dim=1)
        hi = torch.where(chi2 >= c0, chi2, torch.inf).amin(dim=1)
        below = torch.where(rs, torch.maximum(below, lo), below)
        above = torch.where(rs, torch.minimum(above, hi), above)
    return below, above


def chi2_stack_screened_plain(d, de, mT, meT, G, shift, bounds, visit,
                              cut_uf, cut_dot, ph=None, cut_abs=None, *, a1,
                              sm, tb=TB, wthr=None, ignore_model_err=False):
    """Plain version of `chi2_stack_screened`: (pdf (B, Ngrid), s (B,)).
    Absorption is on when `ph` and `cut_abs` are given."""
    B = d.shape[0]
    M = mT.shape[1]
    nb, S = visit.shape
    absorb = ph is not None
    d3, de3 = _rows(d, tb, 0.0), _rows(de, tb, 1.0)
    live = _rows(torch.ones(B, dtype=torch.bool, device=d.device), tb,
                 False)
    sh3 = _rows(shift, tb, 0.0)[..., None]
    bnd_rows = _rows(bounds.T.contiguous(), tb, 0.0)         # (nb, tb, S)
    uf3, dot3 = _rows(cut_uf, tb, 0.0), _rows(cut_dot, tb, 0.0)
    if absorb:
        ph3, abs3 = _rows(ph, tb, 0), _rows(cut_abs, tb, 0.0)
    ar = torch.arange(sm, device=d.device)
    pdf = torch.zeros((nb, tb, G.shape[1]), dtype=d.dtype, device=d.device)
    s = torch.zeros((nb, tb), dtype=d.dtype, device=d.device)
    for p in range(S):
        st = visit[:, p].long()                              # (nb,)
        bnd = torch.gather(bnd_rows, 2, st[:, None, None].expand(nb, tb, 1))
        bnd = bnd[..., 0]
        if absorb:
            rcut = torch.maximum(torch.where(p > ph3, abs3, uf3), dot3)
        else:
            rcut = uf3
        run = (live & (bnd <= rcut)).any(dim=1)
        dot = run & (live & (bnd <= dot3)).any(dim=1)
        if not bool(run.any()):
            continue
        idx = st[:, None] * sm + ar[None, :]                 # (nb, sm)
        valid = (idx < M)[:, None, :]
        mg, meg = _gather_models(mT, meT, idx)
        chi2 = _chi2_blocks(d3, de3, mg, meg, ignore_model_err)
        w = torch.where(valid, _weights_plain(chi2, sh3, a1), 0.0)
        s = torch.where(run[:, None], s + w.sum(dim=2), s)
        if bool(dot.any()):
            if wthr is not None:
                w = torch.where(w > wthr, w, 0.0)
            part = fp32_matmul(w, G[idx.clamp_max(M - 1)])
            pdf = torch.where(dot[:, None, None], pdf + part, pdf)
    return pdf.reshape(nb * tb, -1)[:B], s.reshape(-1)[:B]


def _check_index(name, t, shape, device):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError(f"{name} must be an int32 torch.Tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_blocks(tb, sm, M, device, bulk=False):
    """Subtiles S of `sm` models; on the card `tb` must be the kernels'
    and, for the passes that stage models by bulk copy (`bulk`), `sm` a
    multiple of 4."""
    if int(sm) < 1:
        raise ValueError(f"sm={sm} must be positive")
    if int(tb) < 1:
        raise ValueError(f"tb={tb} must be positive")
    if device.type == "cuda" and int(tb) != TB:
        raise ValueError(f"the screened kernels take object blocks of {TB} "
                         f"rows, got tb={tb}")
    if device.type == "cuda" and bulk and int(sm) % 4:
        raise ValueError(f"the screened passes take subtiles of a multiple "
                         f"of 4 models on the card, got sm={sm}")
    return -(-int(M) // int(sm))


def _lib(name, *sizes):
    """The kernel library, after checking its object block and the
    shared memory that `name` needs at `sizes` (F, and pass B's Ngrid)."""
    lib = _load_checked(name,
                        lambda lib: getattr(lib, f"fz_{name}_smem")(*sizes))
    if lib.fz_screen_tb() != TB:
        raise RuntimeError(f"the built kernels take blocks of "
                           f"{lib.fz_screen_tb()} objects, not {TB}")
    return lib


def screen_bound_seed(d, de, mT, meT, blo, bhi, memax, *, sm, tm, c0,
                      tb=TB, ignore_model_err=False, n_anchor=N_ANCHOR):
    """The screened route's seed stage on sorted objects and models, from
    the subtile boxes: the (S, B) chi^2 lower bounds, each object block's
    least bound per subtile bmin (S, nb), its home tile's first model
    start (nb,) int32 (the tm models around its first least-bound
    subtile) and the seed (B,) float32: the least of the anchor seed
    (chi^2 >= c0 (1 + 1e-3) over min(n_anchor, M) anchors, times 1 +
    1e-4) and the home-tile seed (chi^2 >= c0 over the home tile, times 1
    + 1e-6), +inf where neither finds one.  `tm` is a multiple of `sm`."""
    B, F, M = _check_pair_inputs(d, de, mT, meT)
    S = _check_blocks(tb, sm, M, d.device)
    for name, t in (("blo", blo), ("bhi", bhi), ("memax", memax)):
        _check(name, t, (F, S), d.device)
    sm, tm = int(sm), int(tm)
    if tm < 1 or tm % sm:
        raise ValueError(f"tm={tm} must be a positive multiple of sm={sm}")
    if M == 0:
        raise ValueError("no models to bound")
    if int(n_anchor) < 1:
        raise ValueError(f"n_anchor={n_anchor} must be positive")
    if d.device.type == "cpu":
        return screen_bound_seed_plain(
            d, de, mT, meT, blo, bhi, memax, sm=sm, tm=tm, c0=c0, tb=tb,
            ignore_model_err=ignore_model_err, n_anchor=n_anchor)
    if tm % 4:
        raise ValueError(f"the seed stage takes home tiles of a multiple of "
                         f"4 models on the card, got tm={tm}")
    nb = nblocks(B, tb)
    dev = d.device
    bounds = torch.empty((S, B), dtype=torch.float32, device=dev)
    bmin = torch.empty((S, nb), dtype=torch.float32, device=dev)
    start = torch.empty(nb, dtype=torch.int32, device=dev)
    seed = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return bounds, bmin, start, seed
    A = min(int(n_anchor), M)
    lib = _lib("screen_bound_seed", F)
    mT, meT, ld = _bulk_rows(mT, meT)
    # The float32 constants torch multiplies and compares by.
    f32 = np.float32
    consts = (f32(c0), f32(c0 * (1.0 + 1e-3)), f32(1.0 - 1e-4),
              f32(1.0 + 1e-4), f32(1.0 + 1e-6))
    with torch.cuda.device(dev):
        _check_rc("screen_bound_seed", lib.fz_screen_bound_seed(
            d.data_ptr(), de.data_ptr(), mT.data_ptr(), meT.data_ptr(),
            blo.data_ptr(), bhi.data_ptr(), memax.data_ptr(),
            bounds.data_ptr(), bmin.data_ptr(), start.data_ptr(),
            seed.data_ptr(), B, M, ld, F, S, sm, tm, A, M // A,
            *(float(x) for x in consts), int(bool(ignore_model_err)),
            _stream(dev)))
    screen_bound_seed.launches += 1
    return bounds, bmin, start, seed


def chi2_brackets_screened(d, de, mT, meT, bounds, seed, *, c0, sm, tb=TB,
                           ignore_model_err=False):
    """Screened pass A: chi2_brackets over the subtiles whose block gate
    admits them (some row with bounds <= seed).  Returns (below, above),
    float32 (B,), equal to chi2_brackets' whenever seed >= the final
    `above` on every row."""
    B, F, M = _check_pair_inputs(d, de, mT, meT)
    S = _check_blocks(tb, sm, M, d.device, bulk=True)
    _check("bounds", bounds, (S, B), d.device)
    _check("seed", seed, (B,), d.device)
    if d.device.type == "cpu":
        return chi2_brackets_screened_plain(
            d, de, mT, meT, bounds, seed, c0=c0, sm=sm, tb=tb,
            ignore_model_err=ignore_model_err)
    below = torch.full((B,), -1.0, dtype=torch.float32, device=d.device)
    above = torch.full_like(below, torch.inf)
    if B == 0 or M == 0:
        return below, above
    lib = _lib("chi2_brackets_screened", F)
    mT, meT, ld = _bulk_rows(mT, meT)
    with torch.cuda.device(d.device):
        _check_rc("chi2_brackets_screened", lib.fz_chi2_brackets_screened(
            d.data_ptr(), de.data_ptr(), mT.data_ptr(), meT.data_ptr(),
            bounds.data_ptr(), seed.data_ptr(), below.data_ptr(),
            above.data_ptr(), B, M, ld, F, S, int(sm), float(c0),
            int(bool(ignore_model_err)), _stream(d.device)))
    chi2_brackets_screened.launches += 1
    return below, above


def chi2_stack_screened(d, de, mT, meT, G, shift, bounds, visit, cut_uf,
                        cut_dot, ph=None, cut_abs=None, *, a1, sm, tb=TB,
                        wthr=None, ignore_model_err=False):
    """Screened pass B: chi2_stack over the subtiles the gates admit, each
    block's in its visit order, s a running sum of per-subtile partials
    (each folded from 16 warps' shares in a fixed order) and pdf the same
    per (row, column) over the models that the row keeps (see
    csrc/chi2_screened.cu).  `ph` and `cut_abs` switch the
    absorption cut on; `wthr` is the float32 weight cut or None.  Returns
    (pdf (B, Ngrid), s (B,)), float32."""
    B, F, M = _check_pair_inputs(d, de, mT, meT)
    S = _check_blocks(tb, sm, M, d.device, bulk=True)
    if G.ndim != 2 or G.shape[1] < 1:
        raise ValueError("G must be (M, Ngrid) with Ngrid >= 1")
    ngrid = G.shape[1]
    dev = d.device
    _check("G", G, (M, ngrid), dev)
    for name, t in (("shift", shift), ("cut_uf", cut_uf),
                    ("cut_dot", cut_dot)):
        _check(name, t, (B,), dev)
    _check("bounds", bounds, (S, B), dev)
    _check_index("visit", visit, (nblocks(B, tb), S), dev)
    if (ph is None) != (cut_abs is None):
        raise ValueError("ph and cut_abs go together (absorption)")
    absorb = ph is not None
    if absorb:
        _check_index("ph", ph, (B,), dev)
        _check("cut_abs", cut_abs, (B,), dev)
    if 2.0 * a1 != round(2.0 * a1):
        raise ValueError(f"a1={a1} must be an integer or half-integer")
    if dev.type == "cpu":
        return chi2_stack_screened_plain(
            d, de, mT, meT, G, shift, bounds, visit, cut_uf, cut_dot, ph,
            cut_abs, a1=a1, sm=sm, tb=tb, wthr=wthr,
            ignore_model_err=ignore_model_err)
    pdf = torch.zeros((B, ngrid), dtype=torch.float32, device=dev)
    s = torch.zeros(B, dtype=torch.float32, device=dev)
    if B == 0 or M == 0:
        return pdf, s
    lib = _lib("chi2_stack_screened", F, ngrid)
    mT, meT, ld = _bulk_rows(mT, meT)
    thr = 0.0 if wthr is None else float(np.float32(wthr))
    with torch.cuda.device(dev):
        _check_rc("chi2_stack_screened", lib.fz_chi2_stack_screened(
            d.data_ptr(), de.data_ptr(), mT.data_ptr(), meT.data_ptr(),
            G.data_ptr(), shift.data_ptr(), bounds.data_ptr(),
            visit.data_ptr(), cut_uf.data_ptr(), cut_dot.data_ptr(),
            ph.data_ptr() if absorb else None,
            cut_abs.data_ptr() if absorb else None, pdf.data_ptr(),
            s.data_ptr(), B, M, ld, F, ngrid, S, int(sm), float(a1),
            int(wthr is not None), thr, int(bool(ignore_model_err)),
            int(absorb), _stream(dev)))
    chi2_stack_screened.launches += 1
    return pdf, s


def expf_probe(x):
    """expf(x) by a kernel compiled with the screened kernels' flags (a
    measurement aid: where the card's expf flushes to 0); torch.exp on a
    CPU tensor.  Not a kernel of any route, and not counted."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be contiguous float32")
    if x.device.type == "cpu":
        return torch.exp(x)
    y = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            _check_rc("expf_probe", _build.load().fz_expf_probe(
                x.data_ptr(), y.data_ptr(), x.numel(), _stream(x.device)))
    return y


screen_bound_seed.launches = 0
chi2_brackets_screened.launches = 0
chi2_stack_screened.launches = 0

_WRAPPERS = (screen_bound_seed, chi2_brackets_screened, chi2_stack_screened)


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts():
    """{wrapper name: launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
