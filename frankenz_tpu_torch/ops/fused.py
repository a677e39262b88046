"""
Fused fit -> PDF for one object batch: lnl grid -> lmap / levid ->
thresholded weights -> KDE label PDFs, without the (B, M) grid in memory.

Port of `frankenz_tpu.ops.fused.fused_fit_pdf`.  Four kernel routes
serve every configuration of it:

* "screened", full masks + dim prior + fixed scale (`wt_thresh` set, or
  both thresholds None), the default there as in JAX: the screened trio
  of `frankenz_tpu/ops/fused.py:1400`
  (`_fused_call_fullmask_dimprior_screened`), glued in `ops.screen`:
  objects and models sorted by a photometric key, `screen_seed`,
  `chi2_brackets_screened` and `chi2_stack_screened` skipping the model
  subtiles that a chi^2 lower bound proves inert, bit-equal to the same
  kernels with no skip.

* "fullmask", the same configuration with ``screen=False``: the
  two-pass pair of `frankenz_tpu/ops/fused.py:1688`
  (`_fused_call_fullmask_dimprior`):

    pass A (`kernels.fullmask.chi2_brackets`): per object, the chi^2
        values bracketing c0 = F - 2, where the unimodal lnl(chi2) peaks;
    glue (plain torch, as it was XLA): lmap from the brackets, the shift
        floored at lnl(clamp);
    pass B (`kernels.fullmask.chi2_stack`): w = exp(lnl - lmap), the
        unthresholded sum s, pdf += (w > wt_thresh) @ G, each 64-model
        tile multiplying only its band of G;
    glue: levid = log s + lmap, the PDF rescale, the degenerate-row rule.
    Both passes read the models in band order, sorted once per call, as
    JAX's pair does (ops/fused.py:1701-1704): the brackets are a max and
    a min, so they do not move; s sums in band order.

* "general", every other configuration with a threshold: masked
  photometry, the Normal likelihood (``dim_prior=False``), free scale
  and the cdf mode (``wt_thresh=None`` with ``cdf_thresh``).  The
  counterpart of `_fused_call`'s general body (ops/fused.py:1851-2011),
  without the Mosaic-only padding and G split:

    free scale with model errors: `kernels.general.scale_sweeps` first,
        the per-(object, model group) sweep counts of the scale fixed
        point, which the recompute kernels below then read (on the table
        route it also writes the lnl table);
    wt_thresh, the table route (`_table_route`): each pair's lnl is
        computed once per call into a float32 lnl table, `lnl_reduce`
        (lmap, levid; under free scale with model errors `scale_sweeps`
        writes the table and `lnl_reduce` reads it) then the stack (keeps
        lnl > ln(wt_thresh) + lmap) reading it, per row chunk of at most
        `kernels.general.TABLE_BYTES_MAX` bytes of table, in one buffer.
        The table's columns are the models in band order and its reader
        `lnl_stack_band`, as JAX's masked route sorts them
        (ops/fused.py:1863-1872), except under free scale with model
        errors: `scale_sweeps` converges the caller's model groups and
        writes the table in the caller's order, which `lnl_stack` reads
        (`lnl_stack_read`).  Bit for bit the wrappers' recompute route (no
        table) on the same model order;
    cdf mode: `lnl_reduce_topk` (lmap, levid and the T heaviest
        distinct lnl values with their tie counts, from one walk over
        the models: JAX's reduce and top-T calls in one kernel),
        `cdf_cut` (the exact per-object cut, plain torch) and
        `lnl_cut_stack` (keeps lnl <= cut, and the reference's share of
        a tie group that straddles it) over the models in band order:
        each pair's lnl computed twice a call; with ``cdf_exact=True``,
        rows whose cut the top-T table leaves undetermined find it by
        bisection (`cdf_cut_exact`, `lnl_reduce_split` per step).

* "onepass", both thresholds None off the full-mask routes: the
  single-pass kernel of ops/fused.py:1952-1975 (`lnl_onepass`, after
  `scale_sweeps` under free scale with model errors) over the models in
  band order, and the glue's rescale pdf * exp(lmap - levid).

Every stack reads the models in band order (`band_sort`, JAX's
`_band_sort`, ops/fused.py:243-267): sorted by the centre of their
kernel-matrix support, computed once per call, so each 64-model tile's G
rows are nonzero only in a narrow band of grid columns, the only columns
that get products (JAX's band skip, K7, flags 128-column blocks and runs
only past 128 padded columns; the port takes each tile's exact band at
every Ngrid): the band stacks (`lnl_cut_stack`, `lnl_onepass`), the
table route's reader `lnl_stack_band` (with its producer), and the K1
pair.  The one exception is the table route under free scale with model
errors, above.  The cdf route's reduce and top-T keep the caller's
order; the band order moves lmap by nothing (a max) and levid by float32
reassociation.

On CUDA tensors the routes launch their kernels; on CPU tensors the same
glue runs the kernels' plain versions.  Nothing catches a failed build
or launch.

The free-scale fixed point with model errors converges per (object,
group of ``tm`` models), as the JAX tile does (ops/fused.py:529-539): the
group's max |delta lnl| decides, and the models of a ragged last group
are joined by the JAX glue's padding sentinels.  The groups are the
models in the caller's order, on the band stacks too (model j of the band
order runs sweeps[b, perm[j] // tm]).  (JAX band-sorts the models by
their kernel-matrix support when the padded grid exceeds 128 columns,
ops/fused.py:1863-1872, which regroups them: its free-scale results then
depend on G.  ROADMAP section 3.)

One documented deviation, inherited from the JAX kernels: on rows whose
EVERY chi^2 exceeds the clamp (F <= 19, chi^2 > 30000: insane outliers)
the full-mask routes keep lmap and levid float32-exact, but the PDF is a
uniform mixture over the clamped models instead of the plain path's
argmax row (`frankenz_tpu/ops/fused.py:2029-2035`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build as _build
from ..kernels import fullmask as _fm
from ..kernels import general as _gen
from ..kernels.general import BandSort, band_sort
from . import screen as _screen
from .screen import lmap_and_shift

__all__ = ["fused_fit_pdf", "fused_route", "group_width",
           "kernels_available", "cdf_cut", "cdf_cut_exact", "band_sort",
           "BandSort", "FusedCdfFallback", "TABLE_MARGIN"]

_NEG_INF = float(np.finfo(np.float32).min)
# Device memory the table route leaves free beside its lnl table: the
# batch's PDFs, the sweep table and the glue's temporaries.
TABLE_MARGIN = 2 ** 30


def kernels_available():
    """True when this process can build and launch the CUDA kernels (a
    card and `nvcc`); the counterpart of `pallas_supported`."""
    return torch.cuda.is_available() and _build.nvcc_path() is not None


class FusedCdfFallback(RuntimeError):
    """The cdf_thresh cut is undetermined for some object: its T
    heaviest distinct weights carry less than cdf_thresh of the mass
    (an extremely flat posterior).  Rerun with ``cdf_exact=True``, a
    larger ``cdf_topk`` or the plain composition (ops/fused.py:48)."""


def fused_route(*, full_mask, dim_prior=True, free_scale=False,
                wt_thresh=1e-3, cdf_thresh=None, screen=True):
    """Which kernel route serves a `fused_fit_pdf` call: "screened" (the
    K2 trio, the full-mask default), "fullmask" (the K1 pair, the same
    configuration with ``screen=False``), "general" (the lnl kernels
    with a weight selection) or "onepass" (both thresholds None off the
    full-mask routes).  The same on every device: CPU tensors run the
    kernels' plain versions."""
    cdf_mode = wt_thresh is None and cdf_thresh is not None
    if full_mask and dim_prior and not free_scale and not cdf_mode:
        return "screened" if screen is None or screen else "fullmask"
    if wt_thresh is None and cdf_thresh is None:
        return "onepass"
    return "general"


def group_width(nmodel, tm):
    """The free-scale convergence group: JAX's model tile, `tm` capped at
    the model count rounded up to 128 (ops/fused.py:2135)."""
    return min(int(tm), -(-int(nmodel) // 128) * 128)


def _fullmask_dimprior(d, de, mT, meT, G, *, ignore_model_err, wt_thresh):
    """Glue of `_fused_call_fullmask_dimprior` (ops/fused.py:1742-1815)
    around the two kernels, over the models in band order; returns (pdf,
    lmap, levid), pdf in the exp(lnl - levid) scale."""
    F, M = d.shape[1], mT.shape[1]
    a1 = 0.5 * F - 1.0
    bs = band_sort(G, mT, meT)
    mT, meT = bs.mT, bs.meT
    below, above = _fm.chi2_brackets(d, de, mT, meT, c0=2.0 * a1,
                                     ignore_model_err=ignore_model_err)
    lmap, shift = lmap_and_shift(below, above, F)
    # w = exp(lnl - lmap), so the cut lnl > ln(wt_thresh) + lmap is
    # w > exp(ln(wt_thresh)), computed as the JAX kernel does.
    wthr = (None if wt_thresh is None
            else float(np.exp(np.log(wt_thresh))))
    # The kernels mask the ragged model edge themselves: no sentinel
    # models, so nothing to subtract from s (ops/fused.py:1798-1808).
    pdf, s = _fm.chi2_stack(d, de, mT, meT, bs.G[:M, :bs.ngrid], shift,
                            a1=a1, wthr=wthr,
                            ignore_model_err=ignore_model_err,
                            bands=bs.bands)
    pos = s > 0
    levid = torch.where(pos, torch.log(torch.clamp_min(s, 1e-30)) + lmap,
                        -torch.inf)
    pdf = torch.where(pos[:, None], pdf * torch.exp(lmap - levid)[:, None],
                      0.0)
    return pdf, lmap, levid


def cdf_cut(vals, cnts, levid, cdf_thresh):
    """Per-object selection from the top-T distinct (value, count) table
    (`_cdf_cut`, ops/fused.py:812-834, with the tie group repaired).

    The reference keeps weights whose ascending-sorted inclusive CDF is
    <= 1 - cdf_thresh (pdf.py:512-516): it drops the minimal descending
    prefix whose exclusive-prefix mass reaches cdf_thresh (the largest
    weight always drops).  The cut is the heaviest tracked value whose
    descending exclusive prefix mass reaches cdf_thresh; every lnl <= cut
    is kept.  The group just above the cut (value `tie`) may straddle the
    boundary: its members carry equal weights, and the reference's
    stable sort drops only as many as the mass needs, keeping the
    `nkeep` of lowest model index.  (JAX drops the whole group, on the
    premise that ties come only from duplicate models; float32 lnl
    values also tie at the dim prior's flat peak.)

    Returns (cut, tie, nkeep, ok): `ok` is False where the tracked mass
    never reaches cdf_thresh (cut undetermined: +inf, keep everything).
    """
    w = torch.exp(vals - levid[:, None]) * cnts
    excl = torch.cumsum(w, dim=1) - w
    crossed = excl >= cdf_thresh
    ok = crossed.any(dim=1)
    # The first crossed slot holds the heaviest KEPT value.
    idx = crossed.to(torch.int8).argmax(dim=1)
    cut = torch.gather(vals, 1, idx[:, None])[:, 0]
    # Slot idx - 1: the lightest dropped group.  Its j-th member (j = 0,
    # 1, ...) in the reference's descending order sits at exclusive mass
    # excl + j * g and drops while that is below cdf_thresh.
    prev = (idx - 1).clamp_min(0)[:, None]
    tie = torch.gather(vals, 1, prev)[:, 0]
    g = torch.exp(tie - levid)
    ndrop = torch.ceil((cdf_thresh - torch.gather(excl, 1, prev)[:, 0]) / g)
    nkeep = torch.gather(cnts, 1, prev)[:, 0] - ndrop
    split = ok & (idx > 0) & (nkeep > 0)
    return (torch.where(ok, cut, torch.inf),
            torch.where(split, tie, torch.inf),
            torch.where(split, nkeep, 0.0), ok)


def _f32_key(x):
    """Order-preserving int64 key of float32 values (-0.0 just below
    +0.0); `_key_f32` inverts it."""
    u = x.view(torch.int32)
    return torch.where(u < 0, u ^ 0x7FFFFFFF, u).to(torch.int64)


def _key_f32(k):
    u = k.to(torch.int32)
    return torch.where(u < 0, u ^ 0x7FFFFFFF, u).view(torch.float32)


# Keys of -inf and +inf are fewer than 2**32 apart: 32 halvings leave
# adjacent keys.
_BISECT_STEPS = 32


def cdf_cut_exact(d, de, dm, mT, meT, mmT, levid, cdf_thresh, **flags):
    """`cdf_cut`'s (cut, tie, nkeep) without the top-T table, for rows
    whose table left the cut undetermined.

    The reference keeps a weight while its ascending inclusive CDF is <=
    1 - cdf_thresh of the total.  With above(v) and below(v) the masses
    of the pairs with lnl > v and lnl <= v (`lnl_reduce_split`, one pass
    over the models, each side summed from its own terms), every pair
    with lnl <= v is kept iff (1 - cdf_thresh) above(v) >= cdf_thresh
    below(v), compared in logs.  Bisection over the float32 line keeps
    that true at lo and false at hi (lo = -inf, hi = +inf at first) and
    ends with lo, hi adjacent: no lnl lies between them, cut = lo, and
    the group at hi is the one that straddles the boundary.  Its members
    (weight g each) enter the CDF in model order, so the first nkeep =
    floor(((1 - cdf_thresh) above(lo) - cdf_thresh below(lo)) / g) are
    kept.  34 passes in all.
    """
    B = d.shape[0]
    thr = float(cdf_thresh)
    logit = float(np.log(thr) - np.log1p(-thr))
    lo = torch.full((B,), int(_f32_key(torch.tensor(-np.inf))),
                    dtype=torch.int64, device=d.device)
    hi = torch.full_like(lo, int(_f32_key(torch.tensor(np.inf))))

    def split(k):
        return _gen.lnl_reduce_split(d, de, dm, mT, meT, mmT,
                                     _key_f32(k).contiguous(), **flags)

    for _ in range(_BISECT_STEPS):
        mid = lo + (hi - lo) // 2
        gt, le, _ = split(mid)
        keep = gt - le >= logit
        lo = torch.where(keep, mid, lo)
        hi = torch.where(keep, hi, mid)
    gt, le, n_lo = split(lo)
    n_hi = split(hi)[2]
    tie = _key_f32(hi)
    room = ((1.0 - thr) * torch.exp(gt - levid)
            - thr * torch.exp(le - levid))
    nkeep = torch.minimum(torch.floor(room / torch.exp(tie - levid)),
                          n_lo - n_hi)
    split_group = nkeep > 0
    return (_key_f32(lo), torch.where(split_group, tie, torch.inf),
            torch.where(split_group, nkeep, 0.0))


def _free_table_bytes(device):
    """Bytes the lnl table may take on `device`: on the card its free
    memory and the blocks PyTorch's allocator holds unused, less
    `TABLE_MARGIN`; None (no cap) on the CPU."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    unused = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return free + unused - TABLE_MARGIN


def _table_route(d, de, dm, mT, meT, mmT, G, *, flags, log_thr, sweep_kw):
    """The two-pass threshold route on the lnl table: per row chunk of at
    most `TABLE_BYTES_MAX` bytes of table and at most the memory free
    (`table_rows`, `_free_table_bytes`), the producer (`lnl_reduce`, or
    `scale_sweeps` under free scale with model errors, `sweep_kw` its
    keywords), `lnl_reduce` and the stack, in one buffer.  The models go
    in band order (`band_sort`, once per call) and the stack is
    `lnl_stack_band`, except under free scale with model errors, whose
    sweeps converge the caller's model groups: there the table stays in
    the caller's order and `lnl_stack` reads it.  Rows are independent,
    so chunking changes no bit.  Returns (pdf, lmap, levid), pdf in the
    exp(lnl - levid) scale.  Raises MemoryError when one row of the table
    does not fit: there is no recompute fallback."""
    bs = None
    if sweep_kw is None:
        bs = band_sort(G, mT, meT, mmT)
        mT, meT, mmT = bs.mT, bs.meT, bs.mmT
    B, M = d.shape[0], mT.shape[1]
    rows = _gen.table_rows(B, M, budget=_free_table_bytes(d.device))
    buf = torch.empty((min(rows, B), _gen.table_width(M)),
                      dtype=torch.float32, device=d.device)
    outs = []
    for r0 in range(0, max(B, 1), rows):
        part = [x[r0:r0 + rows] for x in (d, de, dm)]
        table = buf[:part[0].shape[0]]
        fl = dict(flags)
        if sweep_kw is not None:
            fl["sweeps"] = _gen.scale_sweeps(
                *part, mT, meT, mmT, table=table,
                dim_prior=flags["dim_prior"], **sweep_kw)
        lmap, levid = _gen.lnl_reduce(*part, mT, meT, mmT, table=table, **fl)
        if bs is None:
            pdf = _gen.lnl_stack(*part, mT, meT, mmT, G, lmap, levid,
                                 log_thr=log_thr, table=table, **fl)
        else:
            pdf = _gen.lnl_stack_band(table, bs, lmap, levid,
                                      log_thr=log_thr)
        outs.append((pdf, lmap, levid))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(x) for x in zip(*outs))


def _cdf_route(d, de, dm, mT, meT, mmT, bs, *, flags, cdf_thresh, cdf_topk,
               cdf_exact=False):
    """Glue of `_fused_call`'s general body in the cdf mode around the
    general kernels: `lnl_reduce_topk` (JAX's reduce and top-T calls,
    ops/fused.py:1903 and :1920, in one kernel), `cdf_cut`, and the band
    stack `lnl_cut_stack`.  Returns (pdf, lmap, levid, ok), pdf in the
    exp(lnl - levid) scale and `ok` the per-row cdf flag.  `flags` are
    the kernels' flags, with the sweep table under free scale and model
    errors; `bs` the models in band order, which only the stack reads."""
    lmap, levid, vals, cnts = _gen.lnl_reduce_topk(d, de, dm, mT, meT, mmT,
                                                   T=cdf_topk, **flags)
    cut, tie, nkeep, ok = cdf_cut(vals, cnts, levid, float(cdf_thresh))
    # A degenerate row (every model at the floor) tracks no mass, so its
    # cut is undetermined; its PDF is zeroed below whatever the cut, so
    # it counts as determined and keeps nothing.
    degenerate = ~(lmap > _NEG_INF / 2)
    cut = torch.where(degenerate, -torch.inf, cut)
    ok = ok | degenerate
    if cdf_exact:
        # `nonzero` synchronizes with the device: one read per call.
        rows = torch.nonzero(~ok).flatten()
        if rows.numel():
            sub = [t.index_select(0, rows) for t in (d, de, dm, levid)]
            sub_flags = dict(flags)
            if flags["sweeps"] is not None:
                sub_flags["sweeps"] = flags["sweeps"].index_select(0, rows)
            exact = cdf_cut_exact(*sub[:3], mT, meT, mmT, sub[3],
                                  float(cdf_thresh), **sub_flags)
            for t, v in zip((cut, tie, nkeep), exact):
                t[rows] = v
            ok = torch.ones_like(ok)
    cut = cut.contiguous()
    pdf = _gen.lnl_cut_stack(d, de, dm, bs, cut, levid, tie.contiguous(),
                             nkeep.contiguous(), **flags)
    return pdf, lmap, levid, ok


def _onepass(d, de, dm, bs, *, flags):
    """Glue of the one-pass kernel (ops/fused.py:1952-1975) over the
    models in band order: its PDF comes in the exp(lnl - lmap) scale."""
    pdf, lmap, levid = _gen.lnl_onepass(d, de, dm, bs, **flags)
    return pdf * torch.exp(lmap - levid)[:, None], lmap, levid


def _is_full(mask):
    return bool((torch.as_tensor(mask) == 1).all())


def fused_fit_pdf(data, data_err, data_mask, models, models_err,
                  models_mask, G, *, dim_prior=True, ignore_model_err=False,
                  free_scale=False, wt_thresh=1e-3, cdf_thresh=None,
                  full_mask=None, tm=512, scale_ltol=1e-4,
                  scale_max_iter=100, cdf_topk=8, defer_cdf_check=False,
                  cdf_exact=False, screen=None, screen_sub=512,
                  screen_run_all=False, screen_stats=False,
                  screen_absorb=True, screen_home_first=True):
    """Fused fit -> PDF for one object batch.

    Takes the `ops.logprob` inputs plus a row-normalized kernel matrix
    `G` (Nmodel, Ngrid), as tensors on one device (or host arrays, which
    go to the models' device).  Returns (pdf, lmap, levid): unnormalized
    float32 PDFs (Nobj, Ngrid) in the exp(lnl - levid) scale and the GOF
    metrics; the caller normalizes PDFs.  `full_mask=None` reads both
    masks to decide.  Routing: see `fused_route`.

    ``free_scale=True`` with model errors kept runs the scale fixed
    point per (object, group of `tm` models, capped as in `group_width`)
    until the group's max |delta lnl| is at most max(scale_ltol, 4 eps
    max A), at most `scale_max_iter` sweeps (JAX's criterion and
    defaults).  On the screened route `tm` (capped the same way) is the
    seed's home tile and the unit of the visit order.

    ``screen`` (default None, which means True, as in JAX) sends full
    masks with the dim prior at fixed scale through the screened route
    (`ops.screen`, the K2 kernels): objects and models sorted by a
    photometric key, and subtiles of `screen_sub` models (the capped
    `tm` when `screen_sub` does not divide it) skipped where a chi^2
    lower bound proves they add nothing.  The results equal the same
    kernels with every skip disabled (``screen_run_all=True``) bit for
    bit, and the K1 pair (``screen=False``) to float32 reassociation.
    ``screen_absorb`` adds pass B's absorption cut and
    ``screen_home_first`` visits each object block's best-bounded tiles
    first (the natural order otherwise); neither changes a bit of the
    output.  ``screen_stats=True`` returns the three run fractions
    (pass A, pass B's weight work, its stack dot) as a fourth output,
    unless ``defer_cdf_check`` claims it; it raises on another route.

    With ``wt_thresh=None`` and ``cdf_thresh`` set, the reference's
    sorted-CDF weight selection (drop-the-largest quirk included) runs
    on the device from the `cdf_topk` heaviest distinct weights per
    object; where they carry less than cdf_thresh of the mass the cut is
    undetermined and `FusedCdfFallback` is raised -- or, with
    ``defer_cdf_check=True``, a validity flag (a bool tensor on the
    device, True off the cdf mode) comes back as a fourth output, so a
    streaming caller reads it with its results and reruns flagged
    batches.  ``cdf_exact=True`` finds those rows' cuts by bisection on
    the general kernels instead (`cdf_cut_exact`: 34 more passes over
    the models for those rows, and one read of the device); the flag is
    then always True.
    """
    m = torch.as_tensor(models)
    dev = m.device
    f32 = dict(dtype=torch.float32, device=dev)
    d = torch.as_tensor(data, **f32).contiguous()
    de = torch.as_tensor(data_err, **f32).contiguous()
    if full_mask is None:
        full_mask = _is_full(data_mask) and _is_full(models_mask)
    route = fused_route(full_mask=full_mask, dim_prior=dim_prior,
                        free_scale=free_scale, wt_thresh=wt_thresh,
                        cdf_thresh=cdf_thresh, screen=screen)
    if screen_stats and route != "screened":
        raise ValueError("screen_stats=True requires the screened route "
                         "(full masks, dim prior, fixed scale, no cdf)")
    mT = m.to(torch.float32).T.contiguous()
    meT = torch.as_tensor(models_err, **f32).T.contiguous()
    G = torch.as_tensor(G, **f32).contiguous()
    ok = stats = None
    if route == "screened":
        tm = group_width(mT.shape[1], tm)
        sm = int(screen_sub) if tm % int(screen_sub) == 0 else tm
        out = _screen.screened(
            d, de, mT, meT, G, ignore_model_err=ignore_model_err,
            wt_thresh=wt_thresh, sm=sm, tm=tm, run_all=screen_run_all,
            with_stats=screen_stats, absorb=screen_absorb,
            home_first=screen_home_first)
        pdf, lmap, levid = out[:3]
        stats = out[3] if screen_stats else None
    elif route == "fullmask":
        pdf, lmap, levid = _fullmask_dimprior(
            d, de, mT, meT, G, ignore_model_err=ignore_model_err,
            wt_thresh=wt_thresh)
    else:
        dm = torch.as_tensor(data_mask, **f32).contiguous()
        mmT = torch.as_tensor(models_mask, **f32).T.contiguous()
        flags = dict(full_mask=full_mask, dim_prior=dim_prior,
                     ignore_model_err=ignore_model_err,
                     free_scale=free_scale, sweeps=None, tm=None)
        sweep_kw = None
        if free_scale and not ignore_model_err:
            tm = group_width(mT.shape[1], tm)
            flags["tm"] = tm
            sweep_kw = dict(tm=tm, full_mask=full_mask, ltol=scale_ltol,
                            max_iter=scale_max_iter)
        if route == "general" and wt_thresh is not None:
            pdf, lmap, levid = _table_route(
                d, de, dm, mT, meT, mmT, G, flags=flags,
                log_thr=float(np.log(wt_thresh)), sweep_kw=sweep_kw)
        else:
            if sweep_kw is not None:
                flags["sweeps"] = _gen.scale_sweeps(d, de, dm, mT, meT, mmT,
                                                    **sweep_kw)
            bs = band_sort(G, mT, meT, mmT)
            if route == "onepass":
                pdf, lmap, levid = _onepass(d, de, dm, bs, flags=flags)
            else:
                pdf, lmap, levid, ok = _cdf_route(
                    d, de, dm, mT, meT, mmT, bs, flags=flags,
                    cdf_thresh=cdf_thresh, cdf_topk=int(cdf_topk),
                    cdf_exact=cdf_exact)
    # Degenerate rows (every model at the -inf floor): zero PDF, -inf GOF.
    good = lmap > _NEG_INF / 2
    pdf = torch.where(good[:, None], pdf, 0.0)
    lmap = torch.where(good, lmap, -torch.inf)
    levid = torch.where(good, levid, -torch.inf)
    if defer_cdf_check:
        return pdf, lmap, levid, (
            torch.ones((), dtype=torch.bool, device=dev) if ok is None
            else ok.all())
    # `bool()` synchronizes with the device; streaming callers defer.
    if ok is not None and not bool(ok.all()):
        raise FusedCdfFallback(
            f"cdf_thresh cut undetermined for some objects (top-{cdf_topk} "
            "weights carry < cdf_thresh of the mass); pass cdf_exact=True, "
            "raise cdf_topk or use the plain composition")
    if stats is not None:
        return pdf, lmap, levid, stats
    return pdf, lmap, levid
