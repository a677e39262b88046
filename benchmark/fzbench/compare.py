"""The numbers that decide `correct`, from the sampled answers of the
timed calls and the reference's answers for the same rows.

* ``lmap_gap``, ``levid_gap``: the largest ``|got - want| / (1 + |want|)``
  over the rows; a non-finite value that differs from the reference's
  (an object with no usable band has -inf on both sides) reads inf.
* ``pdf_gap``: the largest distance of a PDF cell outside the
  reference's envelope (its PDF where no weight lies within
  `FLIP_BAND_NATS` of the cut; see `reference.Reference.rows`), over the
  largest cell of the reference's row.  An all-zero reference row must
  come back all zero.
"""

from __future__ import annotations

import numpy as np

CHECKS = ("lmap_gap", "levid_gap", "pdf_gap")
# Pairs whose log-weight lies this close to the cut (ln wt_thresh below
# lmap) may fall on either side of it in float32: 100x the float32 error
# of lnl there, 10x the free scale's ltol.
FLIP_BAND_NATS = 1e-3


def gof_gap(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    if not np.array_equal(np.isfinite(got), fin) or not np.array_equal(
            got[~fin], want[~fin]):
        return float("inf")
    if not fin.any():
        return 0.0
    return float(np.max(np.abs(got[fin] - want[fin])
                        / (1.0 + np.abs(want[fin]))))


def pdf_gap(got, lo, hi):
    got = np.asarray(got, np.float64)
    lo, hi = (np.asarray(x, np.float64) for x in (lo, hi))
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    if not np.isfinite(got).all():
        return float("inf")
    scale = hi.max(axis=1)
    excess = np.maximum(np.maximum(got - hi, lo - got), 0.0)
    zero = scale <= 0
    gap = 0.0
    if zero.any():
        gap = float("inf") if np.any(got[zero] != 0) else 0.0
    if (~zero).any():
        gap = max(gap, float(np.max(excess[~zero].max(axis=1)
                                    / scale[~zero])))
    return gap


def readings(got, ref):
    """{check: value} of the answers `got` (pdf, lmap, levid) against the
    reference's `ref` (a `Reference.rows` dict)."""
    pdf, lmap, levid = got
    return {"lmap_gap": gof_gap(lmap, ref["lmap"]),
            "levid_gap": gof_gap(levid, ref["levid"]),
            "pdf_gap": pdf_gap(pdf, ref["pdf_lo"], ref["pdf_hi"])}


def judge(values, limits):
    """(correct, {check: {"value", "limit"}}): every check at or under
    its limit; a check without a number fails."""
    table = {k: {"value": values.get(k), "limit": limits[k]} for k in CHECKS}
    ok = all(v["value"] is not None and np.isfinite(v["value"])
             and v["value"] <= v["limit"] for v in table.values())
    return ok, table
