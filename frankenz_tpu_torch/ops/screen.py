"""
The screened full-mask route: the glue of
`frankenz_tpu.ops.fused._fused_call_fullmask_dimprior_screened`
(frankenz_tpu/ops/fused.py:1400-1680) around the three screened kernels
(`kernels.screened`: `screen_bound_seed`, `chi2_brackets_screened`,
`chi2_stack_screened`).  Plain torch, as it was XLA in JAX, but for the
subtile bounds, the home tiles and the anchor seed, which the seed
stage's kernel computes with the home-tile seed.

Both passes of the full-mask pair mostly compute nothing: pass A needs
only the chi^2 values bracketing c0 = F - 2, pass B's stack only pairs
whose weight passes the threshold, and even its unthresholded sum gets
exact zeros past a per-row chi^2 cut.  Objects and models are sorted by
one photometric key (a Morton interleave of the two highest-variance
filters), so those neighbourhoods are contiguous, and a per-(model
subtile, object) chi^2 lower bound -- the distance to the subtile's
photometric box over its largest variance -- certifies whole subtiles as
skippable.  Every skip is exact: the result equals the same kernels with
every gate open (``run_all``) bit for bit.

Deviations from the JAX glue, none of which moves a result beyond
float32 reassociation:

* no sentinel models: the kernels mask the ragged model edge, so the
  subtile boxes cover real models only and nothing is subtracted from s
  (JAX: ops/fused.py:1651-1656);
* the port's own object blocks (`kernels.screened.TB` rows) and no
  object padding, so the visit order and the run fractions are those of
  the port's blocks;
* the sorted visit table at every size: JAX's zig-zag order (`_zig_tile_of`,
  switched on past `_VISIT_SMEM_MAX`, ops/fused.py:1549) exists only for
  Mosaic's SMEM ceiling; the two orders differ only by reassociation.

Spans (`utils.tracing.span`): ``screen.screened`` (a batch),
``screen.seed`` (`sort_and_bound`) and ``screen.gates`` (`stack_gates`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy.special import gammaln as _sp_gammaln

from ..kernels import fullmask as _fm
from ..kernels import screened as _sk
from ..utils.tracing import spanned

__all__ = ["interleave2", "chi2_upper_root", "locality_sort",
           "subtile_boxes", "screen_prep", "Sorted", "sort_and_bound",
           "Gates", "stack_gates", "run_fractions", "screened",
           "lmap_and_shift", "LN_W_UNDERFLOW", "N_ANCHOR"]

_LOG_2 = 0.6931471805599453
N_ANCHOR = _sk.N_ANCHOR
# ln w at or below which every pass-B weight is exactly 0.0 in float32.
# float32 exp(x) is 0 once x < ln(2^-150) = -103.972 when rounded
# correctly; -104.2 (JAX's constant, ops/fused.py:1504-1506) keeps 0.23
# of margin for the kernels' argument rounding.  Measured (chip_smoke.py
# checks it on every run): the largest x that torch.exp flushes to 0 on
# CPU tensors is -103.972084, on the card see PERF.md.
LN_W_UNDERFLOW = -104.2


def _lnl_of(c, a1, norm):
    """Full-mask dim-prior lnl at chi^2 = c."""
    safe = torch.where(c < 1e-30, 1e-30, c)
    return (a1 * torch.log(safe) if a1 != 0.0 else 0.0) - 0.5 * c - norm


def lmap_and_shift(below, above, nfilt):
    """lmap from pass A's chi^2 brackets, and pass B's exponent shift
    (ops/fused.py:1742-1759, :1485-1497): the glue of both full-mask
    routes."""
    a1 = 0.5 * nfilt - 1.0
    norm = float(_sp_gammaln(0.5 * nfilt) + _LOG_2 * 0.5 * nfilt)
    lmap = torch.maximum(
        torch.where(below >= 0.0, _lnl_of(below, a1, norm), -torch.inf),
        torch.where(torch.isfinite(above), _lnl_of(above, a1, norm),
                    -torch.inf))
    if a1 > _fm.A1_NOLOG_MAX:
        shift = lmap + norm
    else:
        # The no-log kernels clamp chi^2, so floor the shift at
        # lnl(clamp): rows whose every model clamps get w = 1 per pair
        # instead of exp overflow.
        lnl_clamp = float((a1 * np.log(_fm.CHI2_CLAMP) if a1 else 0.0)
                          - 0.5 * _fm.CHI2_CLAMP - norm)
        shift = torch.clamp_min(lmap, lnl_clamp) + norm
    return lmap, shift.contiguous()


def interleave2(a, b):
    """Morton-interleave two 15-bit int32 values -> 30-bit int32 key
    (`_interleave2`, ops/fused.py:1068)."""
    def spread(v):
        v = v & 0x7FFF
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return spread(a) | (spread(b) << 1)


def chi2_upper_root(a1, K, c0):
    """Conservative upper root of f(c) = a1 ln(c) - c/2 = K (c > c0),
    per row (`_chi2_upper_root`, ops/fused.py:1081): 40 Newton steps in
    float32 from right of the peak, each clamped right of c0, then
    inflated by (1 + 1e-5) and 1e-3.  Newton on the concave, decreasing
    branch never undercuts the root, so a skip against it is exact."""
    c = torch.clamp_min(torch.full_like(K, c0 + 1.0), 1e-3)
    floor = torch.tensor(c0 * (1.0 + 1e-6) + 1e-6, dtype=torch.float32,
                         device=K.device)
    for _ in range(40):
        if a1 != 0.0:
            f = a1 * torch.log(c) - 0.5 * c
            fp = a1 / c - 0.5
        else:
            f = -0.5 * c
            fp = torch.full_like(c, -0.5)
        c = c + (K - f) / fp
        c = torch.maximum(c, floor)
    return c * (1.0 + 1e-5) + 1e-3


def locality_sort(d, mT):
    """(operm, mperm): stable argsorts of the objects' and the models'
    Morton keys over the models' two highest-variance filters
    (`_screen_prep`, ops/fused.py:1125-1148)."""
    var = mT.var(dim=1, correction=0)           # jnp.var: ddof 0
    # The two highest-variance filters, ties to the lower index as
    # jax.lax.top_k (F = 1: the one filter twice).
    dims = torch.argsort(var, descending=True, stable=True)[:2]
    lo = mT.amin(dim=1)
    hi = mT.amax(dim=1)
    scale = 1.0 / torch.clamp_min(hi - lo, 1e-20)

    def key_of(rows):
        q = torch.clamp((rows - lo[None, :]) * scale[None, :], 0.0, 1.0)
        q2 = torch.nan_to_num(q[:, dims], nan=0.0)
        qi = (q2 * 32767.0).to(torch.int32)     # truncates, as astype
        return interleave2(qi[:, 0], qi[:, -1])

    return (torch.argsort(key_of(d), stable=True),
            torch.argsort(key_of(mT.T), stable=True))


def subtile_boxes(mT, meT, sm):
    """(blo, bhi, memax), each (F, S), S = ceil(M / sm): the photometric
    box and the largest model error of each subtile of `sm` consecutive
    (sorted) models, over real models only: the ragged last subtile's
    missing slots take the neutral element of each reduction."""
    F, M = mT.shape
    S = -(-M // sm)
    pad = S * sm - M
    pad_with = lambda x, v: torch.nn.functional.pad(x, (0, pad), value=v)  # noqa: E731
    return (pad_with(mT, torch.inf).reshape(F, S, sm).amin(dim=2),
            pad_with(mT, -torch.inf).reshape(F, S, sm).amax(dim=2),
            pad_with(meT, -torch.inf).reshape(F, S, sm).amax(dim=2))


def screen_prep(d, de, mT, meT, sm, c0, ignore_model_err,
                n_anchor=N_ANCHOR):
    """Locality sort, subtile boxes, chi^2 lower bounds and anchor seeds
    (`_screen_prep`, ops/fused.py:1105-1205), over real models only, in
    plain torch (the seed stage's plain pieces).

    Returns (operm, mperm, bounds, seed): the object and model
    permutations (stable argsorts of the Morton keys); `bounds` (S, B),
    S = ceil(M / sm), a lower bound of every chi^2 of each sorted object
    in each subtile of sorted models, deflated by 1e-4; `seed` (B,) the
    least anchor chi^2 >= c0 (1 + 1e-3) over `n_anchor` models spread
    evenly through the sorted order, inflated by 1e-4 (+inf where none
    qualifies): an upper bound of pass A's final `above`.
    """
    operm, mperm = locality_sort(d, mT)
    mT, meT = mT[:, mperm], meT[:, mperm]
    d, de = d[operm], de[operm]
    bound = _sk.subtile_bounds_plain(d, de, *subtile_boxes(mT, meT, sm),
                                     ignore_model_err)
    seed = _sk.anchor_seed_plain(d, de, mT, meT, c0, ignore_model_err,
                                 n_anchor)
    return operm, mperm, bound, seed


def _visit_table(bmin, tm_sub, home_first):
    """Each object block's subtiles in visit order, (nb, S) int32: its
    tiles of `tm_sub` subtiles ascending by the block's least bound
    (stable), the subtiles of a tile in model order; the natural order
    without `home_first` (ops/fused.py:1550-1577)."""
    S, nb = bmin.shape
    if not home_first:
        return (torch.arange(S, device=bmin.device, dtype=torch.int32)
                .expand(nb, S).contiguous())
    nm = -(-S // tm_sub)
    tmin = torch.nn.functional.pad(bmin, (0, 0, 0, nm * tm_sub - S),
                                   value=torch.inf)
    tmin = tmin.reshape(nm, tm_sub, nb).amin(dim=1)              # (nm, nb)
    tiles = torch.argsort(tmin.T, dim=1, stable=True)            # (nb, nm)
    sub = (tiles[:, :, None] * tm_sub
           + torch.arange(tm_sub, device=bmin.device)).reshape(nb, -1)
    # Only the last tile can be short: drop its missing subtiles.
    return sub[sub < S].reshape(nb, S).to(torch.int32).contiguous()


@dataclass
class Sorted:
    """A batch sorted and bounded for the kernels (`sort_and_bound`):
    objects (d, de) and models (mT, meT, rows of G) in key order, the
    object permutation, bounds (S, B), the seed (B,) (the anchor and
    home-tile seeds' min), each block's least bound bmin (S, nb) and
    home-tile start (nb,) int32, the subtile boxes (blo, bhi, memax), and
    the sizes: subtile sm, home tile tm, object block tb."""
    d: torch.Tensor
    de: torch.Tensor
    mT: torch.Tensor
    meT: torch.Tensor
    G: torch.Tensor
    operm: torch.Tensor
    bounds: torch.Tensor
    seed: torch.Tensor
    bmin: torch.Tensor
    start: torch.Tensor
    boxes: tuple
    sm: int
    tm: int
    tb: int


@spanned("screen.seed")
def sort_and_bound(d, de, mT, meT, G, *, sm, tm, tb, ignore_model_err):
    """The locality sort, the sorted copies, the subtile boxes and the
    seed stage (`kernels.screened.screen_bound_seed`: bounds, block
    minima, home tiles, seed; ops/fused.py:1424-1469).  `tm` is a
    multiple of `sm`."""
    operm, mperm = locality_sort(d, mT)
    d, de = d[operm].contiguous(), de[operm].contiguous()
    mT, meT = mT[:, mperm].contiguous(), meT[:, mperm].contiguous()
    boxes = subtile_boxes(mT, meT, sm)
    bounds, bmin, start, seed = _sk.screen_bound_seed(
        d, de, mT, meT, *boxes, sm=sm, tm=tm, c0=float(d.shape[1] - 2),
        tb=tb, ignore_model_err=ignore_model_err)
    return Sorted(d, de, mT, meT, G[mperm].contiguous(), operm, bounds,
                  seed, bmin, start, boxes, int(sm), int(tm), int(tb))


@dataclass
class Gates:
    """Pass B's per-row inputs from pass A's brackets (`stack_gates`):
    lmap and shift (B,), the chi^2 cuts cut_uf, cut_dot (B,), the visit
    table (nb, S) int32 and every (subtile, object)'s visit position
    (S, B); with absorption ph (B,) int32 and cut_abs (B,), else None."""
    lmap: torch.Tensor
    shift: torch.Tensor
    cut_uf: torch.Tensor
    cut_dot: torch.Tensor
    visit: torch.Tensor
    vpos: torch.Tensor
    ph: torch.Tensor | None
    cut_abs: torch.Tensor | None


@spanned("screen.gates")
def stack_gates(srt, below, above, *, wt_thresh, absorb=True,
                home_first=True):
    """lmap, the shift and every pass-B cut (ops/fused.py:1485-1585),
    from the real bounds."""
    B, F = srt.d.shape
    a1 = 0.5 * F - 1.0
    c0 = 2.0 * a1
    S = srt.bounds.shape[0]
    nb = srt.bmin.shape[1]
    lmap, shift = lmap_and_shift(below, above, F)

    # Per-row chi^2 cuts in the kernel's weight convention ln w = f(c) -
    # shift, f(c) = a1 ln c - c/2 (ops/fused.py:1500-1522): weights are
    # exactly 0.0 past cut_uf, fail w > wthr past cut_dot.  In the no-log
    # form w is constant past the clamp, so a root that does not clear
    # it never skips.
    #
    # The absorption cut (ops/fused.py:1524-1536): past ph, the last
    # visit position whose bound admits the row's peak chi^2 (cut_heavy),
    # s holds the peak weight ~1 (>= 0.5), and a subtile whose weight-sum
    # bound sm exp(f(bound) - shift) is under half an ulp of 0.5 adds
    # nothing: cut_abs.  delta_abs = ln(sm) + 25 ln 2 + 1.0: the 1.0 covers
    # the float32 evaluation error of f between the glue (log, here) and
    # the kernel (the sqrt chain and expf, or logf), both IEEE on the card
    # and both below 0.01 for chi^2 <= 3e4.
    #
    # One Newton run for every cut: the rows of K are independent.
    delta_abs = float(np.log(srt.sm) + 25.0 * np.log(2.0) + 1.0)
    offsets = [LN_W_UNDERFLOW]
    if wt_thresh is not None:
        offsets.append(float(np.log(wt_thresh)))
    if absorb:
        offsets += [-delta_abs, -0.5]
    cuts = chi2_upper_root(a1, torch.stack([shift + o for o in offsets]),
                           c0)
    if a1 <= _fm.A1_NOLOG_MAX:
        cuts = torch.where(cuts < _fm.CHI2_CLAMP, cuts, torch.inf)
    cuts = torch.where(torch.isfinite(lmap)[None, :], cuts, torch.inf)
    cut_uf = cuts[0]
    cut_dot = cut_uf if wt_thresh is None else cuts[1]

    visit = _visit_table(srt.bmin, srt.tm // srt.sm, home_first)
    # Visit position of every (subtile, object): (S, B).
    vpos = torch.empty_like(visit)
    vpos.scatter_(1, visit.long(), torch.arange(
        S, dtype=torch.int32, device=visit.device).expand(nb, S).contiguous())
    vpos = vpos[torch.arange(B, device=visit.device) // srt.tb].T
    ph = cut_abs = None
    if absorb:
        cut_abs, cut_heavy = cuts[-2].contiguous(), cuts[-1]
        ph = torch.where(srt.bounds <= cut_heavy[None, :], vpos,
                         -1).amax(dim=0)
        ph = torch.where(ph >= 0, ph, S).to(torch.int32).contiguous()
    return Gates(lmap, shift, cut_uf.contiguous(), cut_dot.contiguous(),
                 visit, vpos, ph, cut_abs)


def run_fractions(srt, seed, gates):
    """The (3,) run fractions over (subtile, object block): pass A's
    seed gate, pass B's run gate and its dot gate (ops/fused.py:
    1668-1680), from the real bounds."""
    def frac(cut):
        return _sk.block_any(srt.bounds <= cut, srt.tb).to(
            torch.float32).mean()

    if gates.ph is not None:
        gate_run = torch.maximum(
            torch.where(gates.vpos > gates.ph[None, :],
                        gates.cut_abs[None, :], gates.cut_uf[None, :]),
            gates.cut_dot[None, :])
    else:
        gate_run = gates.cut_uf[None, :]
    return torch.stack([frac(seed[None, :]), frac(gate_run),
                        frac(gates.cut_dot[None, :])])


@spanned("screen.screened")
def screened(d, de, mT, meT, G, *, ignore_model_err, wt_thresh, sm, tm,
             tb=_sk.TB, run_all=False, with_stats=False, absorb=True,
             home_first=True):
    """The screened route for one batch; returns (pdf, lmap, levid) in
    the caller's object order, pdf in the exp(lnl - levid) scale, and
    with ``with_stats`` the (3,) `run_fractions`.

    ``run_all`` forces -inf into the kernels' bound operand only: every
    gate opens, and every structural quantity (visit order, home tiles,
    ph, stats) still comes from the real bounds, so a screened call and a
    run-all call accumulate in the same order (ops/fused.py:1432-1439).
    `tm` is the home tile of the seed and the unit of the visit order, a
    multiple of the subtile `sm`."""
    B, F = d.shape
    M = mT.shape[1]
    a1 = 0.5 * F - 1.0
    c0 = 2.0 * a1
    if B == 0 or M == 0:
        # Nothing to sort: every row (if any) is degenerate.
        neg = torch.full((B,), -torch.inf, dtype=d.dtype, device=d.device)
        out = (torch.zeros((B, G.shape[1]), dtype=d.dtype, device=d.device),
               neg, neg.clone())
        return (*out, torch.zeros(3, device=d.device)) if with_stats else out
    srt = sort_and_bound(d, de, mT, meT, G, sm=sm, tm=tm, tb=tb,
                         ignore_model_err=ignore_model_err)
    bounds_k = (torch.full_like(srt.bounds, -torch.inf) if run_all
                else srt.bounds)
    kw = dict(tb=tb, ignore_model_err=ignore_model_err)
    args = (srt.d, srt.de, srt.mT, srt.meT)
    below, above = _sk.chi2_brackets_screened(*args, bounds_k, srt.seed,
                                              c0=c0, sm=sm, **kw)
    gates = stack_gates(srt, below, above, wt_thresh=wt_thresh,
                        absorb=absorb, home_first=home_first)
    wthr = (None if wt_thresh is None
            else float(np.exp(np.log(wt_thresh))))
    pdf, s = _sk.chi2_stack_screened(
        *args, srt.G, gates.shift, bounds_k, gates.visit, gates.cut_uf,
        gates.cut_dot, gates.ph, gates.cut_abs, a1=a1, sm=sm, wthr=wthr,
        **kw)

    lmap = gates.lmap
    pos = s > 0
    levid = torch.where(pos, torch.log(torch.clamp_min(s, 1e-30)) + lmap,
                        -torch.inf)
    pdf = torch.where(pos[:, None], pdf * torch.exp(lmap - levid)[:, None],
                      0.0)
    # Undo the object sort (rows are independent; the model sort only
    # reassociates the sums).
    inv = torch.empty_like(srt.operm)
    inv[srt.operm] = torch.arange(B, device=d.device)
    out = (pdf[inv], lmap[inv], levid[inv])
    if not with_stats:
        return out
    return (*out, run_fractions(srt, srt.seed, gates))
