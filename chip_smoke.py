#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`frankenz_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (or any
sm_90a card), `nvcc` and PyTorch built for CUDA.  It imports only the
port, numpy and scipy, and:

1. prints the card (`nvidia-smi` name and power limit) and versions;
2. builds the CUDA kernels from ``frankenz_tpu_torch/csrc`` (timed);
3. holds each full-mask kernel against its plain PyTorch version on the
   card, at the config-4 widths (F=5, 100,000 models, a 301-point
   PDFDict grid, 2,048 objects) and three edge shapes (ragged M=99,937
   with B=1,000; F=20, the log-form weight; an all-clamped outlier row),
   with times of both (CUDA events, median of 5);
4. drives `BruteForce.fit_predict` over 131,072 objects (two 65,536-object
   batches x 100,000 models x 301 grid points) with the launch counters
   reset just before, checks the output, checks 1,024 rows against the
   plain composition on the card, and checks `fit_summarize` against
   `pdfs_summarize(fit_predict(...))` under the same uniforms;
5. masked photometry (each data band missing with probability 0.15,
   from ``default_rng(2)``: about 10 of the 131,072 rows lose every
   band): holds the four general kernels against their plain versions
   at B=2,048 on six cases (masked dim prior; model masks too; the
   Normal likelihood on full masks; ragged M=99,937 with B=1,000; rows
   with Ndim 0, 1 and 2; duplicate models, whose lnl ties), then drives
   masked `fit_predict` over the 131,072 objects (the general route:
   `lnl_reduce` + `lnl_stack`, and not the full-mask pair), `fit_summarize`,
   the cdf mode over one 65,536-object batch (`lnl_reduce` + `lnl_topk` +
   `lnl_cut_stack`, no batch rerun), and a flat-posterior batch whose cut
   is undetermined at cdf_thresh 0.999999 and 0.5 (it must rerun, find
   the cut by bisection with `lnl_reduce_split`, and agree with the
   plain composition); one-pass (`lnl_onepass`) joins each of the six
   cases, and at the batch it is timed beside `lnl_reduce` + `lnl_stack`
   keeping every weight;
6. free scale (K6) and no weight threshold (K4): every free-scale
   instantiation (model errors or not x full or masked x dim prior or
   Normal) against its plain version at B=2,048 on config-8 data
   (bench.py:628-649: scaled noisy model copies), the sweep tables equal;
   config 8 end to end (16,384 objects, free scale with model errors,
   wt_thresh 1e-3, ltol 1e-4: `scale_sweeps` + `lnl_reduce` +
   `lnl_stack`), every row against the plain composition in 2,048-row
   batches, and `fit_summarize`; free scale without model errors over
   one masked 65,536 batch under wt_thresh, the cdf mode and no
   threshold (one-pass), and a flat-posterior batch that reruns through
   the bisection; fixed scale with no threshold over one masked batch
   (`lnl_onepass` alone); the free-scale kernel times at config 8's batch;
7. prints one JSON line of kernel results (fixed-scale entry points by
   their wrapper's name, free-scale ones with the suffix ``_fs``, and
   `scale_sweeps`), the card line again, and last
   ``{"ok": true, "device": {...}}``.

Matmul precision: TF32 is switched off and float32 matmul precision set
to "highest", so every plain product and summary dot is full float32.
Any failed check exits non-zero before the ``ok`` line.  Without CUDA, or
without the package beside this script, it exits 1 at once.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# Config 4 (the serving benchmark shape of the JAX package): models,
# filters, grid points, objects per fit_predict batch.
NMODEL, NFILT, NGRID, BATCH = 100_000, 5, 301, 65_536
N_E2E = 2 * BATCH
N_KERNEL = 2_048
N_SUBSET = 1_024
WT_THRESH = 1e-3

# Tolerances.  Brackets: kernel and plain version round the same
# operations in the same order (expected bit-equal; 2e-7 admits 1 ulp).
# Weight sums: the same weights summed in another order (1e-5).  PDFs:
# row-normwise 1e-5 of the row maximum, else the threshold-flip envelope
# (a weight within 0.2% of the cut may land on either side).  End to
# end against the plain composition: tests/test_fused.py's 2e-5 (GOF)
# and rtol 2e-3 / atol 2e-5 (PDFs).  Summaries: 2e-5 / 2e-6.
TOL_BRACKET = 2e-7
TOL_SUM = 1e-5
TOL_PDF_ROW = 1e-5
FLIP = 1.002
# General kernels: lmap and the top-T values are lnl values themselves
# (the kernels and the plain versions round every operation in the same
# order): bit-equal or 1 ulp.  levid: the same weights summed in another
# order; levid's absolute error is the weight sum's relative error, so
# it is held to 1e-5 of max(1, |levid|).  PDFs as above; the flip
# envelope moves the lnl cut by log(FLIP) (wt_thresh) or by one ulp (the
# cdf cut), and the end-to-end cdf check moves cdf_thresh by FLIP.
TOL_ULP = 1.0
P_MISSING = 0.15
CDF_THRESH = 2e-4
GENERAL = ("lnl_reduce", "lnl_reduce_split", "lnl_stack", "lnl_topk",
           "lnl_cut_stack")
# Free scale end to end against the plain composition: JAX's own GOF
# tolerances, tests/test_fused.py:145-150 (datum-only variance, 1e-4)
# and :182-187 (model errors kept, 1e-3: the kernels converge the scale
# per (object, 512-model group), the plain likelihood per object over
# every model).  Config 8 (bench.py:612-699): objects per batch.
TOL_GOF_FS_IME = 1e-4
TOL_GOF_FS_ME = 1e-3
N8 = 16_384
PLAIN_BATCH_FS = 2_048


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip() if out else "unknown"


def median_ms(torch, fn, reps=5):
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def rel_err(torch, got, want):
    """(max abs, max rel) over entries finite in `want`; infinities must
    sit in the same places."""
    fin = torch.isfinite(want)
    check(torch.equal(fin, torch.isfinite(got))
          and torch.equal(got[~fin], want[~fin]),
          "non-finite entries differ")
    diff = (got[fin] - want[fin]).abs()
    if diff.numel() == 0:
        return 0.0, 0.0
    rel = diff / want[fin].abs().clamp_min(1e-30)
    return float(diff.max()), float(rel.max())


def pdf_rows_close(torch, got, want, lo_fn, hi_fn, tol):
    """Row-normwise closeness, or inside the threshold-flip envelope
    [min(lo, hi), max(lo, hi)] (+- tol of the row maximum), lo and hi
    computed by `lo_fn` / `hi_fn` only when needed (None: no envelope,
    no weight threshold to flip)."""
    scale = want.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    err = (got - want).abs() / scale
    if float(err.max()) <= tol or lo_fn is None:
        return float(err.max()), float(err.max()) <= tol
    lo, hi = lo_fn(), hi_fn()
    env_lo = torch.minimum(lo, hi) - tol * scale
    env_hi = torch.maximum(lo, hi) + tol * scale
    inside = bool(((got >= env_lo) & (got <= env_hi)).all())
    return float(err.max()), inside


def ulp_err(torch, got, want):
    """(max abs, max distance in float32 ulps of `want`) over entries
    finite in `want`; infinities must sit in the same places."""
    max_abs, _ = rel_err(torch, got, want)
    fin = torch.isfinite(want)
    w = want[fin].abs()
    spacing = torch.nextafter(w, torch.full_like(w, torch.inf)) - w
    if w.numel() == 0:
        return max_abs, 0.0
    return max_abs, float(((got[fin] - want[fin]).abs() / spacing).max())


def levid_err(torch, got, want):
    """(max abs, max |got - want| / (1 + |want|)) over finite entries;
    infinities must sit in the same places."""
    max_abs, _ = rel_err(torch, got, want)
    fin = torch.isfinite(want)
    if not bool(fin.any()):
        return max_abs, 0.0
    return max_abs, float(((got[fin] - want[fin]).abs()
                           / (1.0 + want[fin].abs())).max())


def general_cases(np, rng, data, models, dmask):
    """The six kernel-vs-plain cases of the general kernels: (name, data
    rows, data mask, models, model mask, flags)."""
    f32 = np.float32
    ones_m = np.ones_like(models)
    mmask = (rng.uniform(size=models.shape) > 0.1).astype(f32)
    mmask[:, :2] = 1.0  # as tests/test_fused.py:35-41
    edge = dmask[:64].copy()
    edge[0] = 0.0                   # Ndim 0: a degenerate row
    edge[1] = [1, 0, 0, 0, 0]       # Ndim 1
    edge[2] = [1, 1, 0, 0, 0]       # Ndim 2: a1 = 0
    dup = models.copy()
    dup[NMODEL // 2:] = dup[:NMODEL // 2]
    masked = dict(full_mask=False)
    return [
        ("masked_dimprior", data[:N_KERNEL], dmask[:N_KERNEL], models,
         ones_m, masked),
        ("masked_model_masks", data[:N_KERNEL], dmask[:N_KERNEL], models,
         mmask, masked),
        ("normal_fullmask", data[:N_KERNEL], np.ones_like(dmask[:N_KERNEL]),
         models, ones_m, dict(full_mask=True, dim_prior=False)),
        ("ragged_M99937_B1000", data[:1_000], dmask[:1_000],
         models[:99_937], ones_m[:99_937], masked),
        ("edge_ndim_rows", data[:64], edge, models, ones_m, masked),
        ("duplicate_models", data[:N_KERNEL], dmask[:N_KERNEL], dup, ones_m,
         masked),
    ]


def general_kernel_case(torch, np, GK, TF, tens, card, G, case,
                        plain_reps=5):
    """Hold the general kernels (with `lnl_onepass`, and `scale_sweeps`
    under free scale with model errors) against their plain versions on
    one case; returns {kernel: result}.  `plain_reps` = 1 times the
    plain version by the call that is compared (free scale with model
    errors: seconds per call)."""
    name, d_np, dm_np, m_np, mm_np, flags = case
    Gc = G[:m_np.shape[0]].contiguous()
    args = [tens(x) for x in (d_np, np.full(d_np.shape, 0.25, np.float32),
                              dm_np, m_np.T, (0.05 * m_np).T, mm_np.T)]
    log_thr = float(np.log(WT_THRESH))
    out = {}

    def run(kernel, plain):
        got = kernel()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        want = plain()
        t1.record()
        t1.synchronize()
        pms = (t0.elapsed_time(t1) if plain_reps <= 1
               else median_ms(torch, plain, reps=plain_reps))
        return got, want, median_ms(torch, kernel,
                                    reps=5 if plain_reps > 1 else 3), pms

    if flags.get("free_scale") and not flags.get("ignore_model_err"):
        kw = dict(tm=TF.group_width(m_np.shape[0], 512),
                  full_mask=flags.get("full_mask", False))
        got, want, ms, pms = run(lambda: GK.scale_sweeps(*args, **kw),
                                 lambda: GK.scale_sweeps_plain(*args, **kw))
        check(torch.equal(got, want), f"{name}: scale_sweeps tables differ")
        out["scale_sweeps"] = dict(
            max_abs_err=0.0, mean_sweeps=float(want.float().mean()),
            max_sweeps=int(want.max()), ms=ms, plain_ms=pms)
        flags = dict(flags, sweeps=got, tm=kw["tm"])

    got, want, ms, pms = run(lambda: GK.lnl_reduce(*args, **flags),
                             lambda: GK.lnl_reduce_plain(*args, **flags))
    a0, u0 = ulp_err(torch, got[0], want[0])
    a1, r1 = levid_err(torch, got[1], want[1])
    check(u0 <= TOL_ULP, f"{name}: lnl_reduce lmap {u0} ulp from plain")
    check(r1 <= TOL_SUM, f"{name}: lnl_reduce levid err {r1}")
    out["lnl_reduce"] = dict(max_abs_err=max(a0, a1), lmap_ulp=u0,
                             levid_err=r1, ms=ms, plain_ms=pms)
    lmap, levid = want

    # The bisection's pass, split at 3 below lmap (a degenerate row's
    # lmap - 3 rounds back to the floor).
    split = lmap - 3.0
    got, want, ms, pms = run(
        lambda: GK.lnl_reduce_split(*args, split, **flags),
        lambda: GK.lnl_reduce_split_plain(*args, split, **flags))
    errs = [levid_err(torch, g, w) for g, w in zip(got[:2], want[:2])]
    r1 = max(e[1] for e in errs)
    check(r1 <= TOL_SUM, f"{name}: lnl_reduce_split sides err {r1}")
    check(torch.equal(got[2], want[2]), f"{name}: lnl_reduce_split counts")
    out["lnl_reduce_split"] = dict(max_abs_err=max(e[0] for e in errs),
                                   sides_err=r1, ms=ms, plain_ms=pms)

    got, want, ms, pms = run(
        lambda: GK.lnl_topk(*args, T=8, **flags),
        lambda: GK.lnl_topk_plain(*args, T=8, **flags))
    a0, u0 = ulp_err(torch, got[0], want[0])
    check(u0 <= TOL_ULP, f"{name}: lnl_topk values {u0} ulp from plain")
    check(torch.equal(got[1], want[1]), f"{name}: lnl_topk tie counts")
    out["lnl_topk"] = dict(max_abs_err=a0, vals_ulp=u0,
                           max_ties=float(want[1][:, 0].max()), ms=ms,
                           plain_ms=pms)
    if name == "duplicate_models":
        check(float(want[1].max()) >= 2.0, "duplicate models did not tie")
    cut, tie, nkeep, _ = TF.cdf_cut(*want, levid, CDF_THRESH)

    def stack(fn, thr):
        return fn(*args, Gc, lmap, levid, log_thr=thr, **flags)

    def cut_stack(fn, c):
        return fn(*args, Gc, c, levid, tie, nkeep, **flags)

    inf = torch.full_like(cut, torch.inf)
    for kname, kernel, plain, lo, hi in (
            ("lnl_stack", lambda: stack(GK.lnl_stack, log_thr),
             lambda: stack(GK.lnl_stack_plain, log_thr),
             lambda: stack(GK.lnl_stack_plain, log_thr + np.log(FLIP)),
             lambda: stack(GK.lnl_stack_plain, log_thr - np.log(FLIP))),
            ("lnl_cut_stack", lambda: cut_stack(GK.lnl_cut_stack, cut),
             lambda: cut_stack(GK.lnl_cut_stack_plain, cut),
             lambda: cut_stack(GK.lnl_cut_stack_plain,
                               torch.nextafter(cut, -inf)),
             lambda: cut_stack(GK.lnl_cut_stack_plain,
                               torch.nextafter(cut, inf)))):
        got, want, ms, pms = run(kernel, plain)
        p_row, ok = pdf_rows_close(torch, got, want, lo, hi, TOL_PDF_ROW)
        check(ok, f"{name}: {kname} PDFs differ beyond the threshold-flip "
                  f"envelope (row-normwise {p_row})")
        out[kname] = dict(max_abs_err=float((got - want).abs().max()),
                          max_rel_err=p_row, ms=ms, plain_ms=pms)

    # No weight threshold: lmap and levid as lnl_reduce's, the PDF (in
    # the exp(lnl - lmap) scale) row-normwise, with no envelope.
    got, want, ms, pms = run(lambda: GK.lnl_onepass(*args, Gc, **flags),
                             lambda: GK.lnl_onepass_plain(*args, Gc, **flags))
    a0, u0 = ulp_err(torch, got[1], want[1])
    a1, r1 = levid_err(torch, got[2], want[2])
    p_row, ok = pdf_rows_close(torch, got[0], want[0], None, None,
                               TOL_PDF_ROW)
    check(u0 <= TOL_ULP, f"{name}: lnl_onepass lmap {u0} ulp from plain")
    check(r1 <= TOL_SUM, f"{name}: lnl_onepass levid err {r1}")
    check(ok, f"{name}: lnl_onepass PDFs differ (row-normwise {p_row})")
    out["lnl_onepass"] = dict(
        max_abs_err=max(a0, a1, float((got[0] - want[0]).abs().max())),
        lmap_ulp=u0, levid_err=r1, max_rel_err=p_row, ms=ms, plain_ms=pms)
    shown = {k: v for k, v in flags.items() if k != "sweeps"}
    sw = out.get("scale_sweeps")
    print(f"kernel_vs_plain {name}: B={d_np.shape[0]} M={m_np.shape[0]} "
          f"F={d_np.shape[1]} {shown} | " + " | ".join(
              f"{k} abs {v['max_abs_err']:.3g} {v['ms']:.3f} ms (plain "
              f"{v['plain_ms']:.3f} ms)" for k, v in out.items())
          + f" | lmap {out['lnl_reduce']['lmap_ulp']:.3g} ulp, levid err "
          f"{out['lnl_reduce']['levid_err']:.3g}, top-T "
          f"{out['lnl_topk']['vals_ulp']:.3g} ulp"
          + (f", sweeps mean {sw['mean_sweeps']:.4g} max {sw['max_sweeps']}"
             " (tables equal)" if sw else "")
          + f" | card {card}", flush=True)
    del args
    torch.cuda.empty_cache()
    return out


def check_vs_plain(np, bf, got, sub, fp_kw, what, cdf=False,
                   key="wt_thresh", gof_tol=2e-5, plain_kw=None):
    """`got` = (pdfs, (lmap, levid)) on the rows of `sub` against the
    plain composition on the card (`plain_kw`: extra keywords of the
    plain calls only): GOF within gof_tol (relative and absolute), PDFs
    within rtol 2e-3 / atol 2e-5 or, on the rows where they are not,
    inside the flip envelope (the threshold `key`, cdf_thresh with
    ``cdf``, moved by FLIP either way; ``key=None``: no threshold, no
    envelope).  Returns the count of PDF cells outside rtol."""
    plain_kw = dict(fp_kw, use_fused=False, **(plain_kw or {}))
    plain = bf.fit_predict(*sub, **plain_kw)
    for k, nm in ((0, "lmap"), (1, "levid")):
        a, b = got[1][k], plain[1][k]
        check(np.array_equal(np.isfinite(a), np.isfinite(b))
              and np.array_equal(a[~np.isfinite(b)], b[~np.isfinite(b)]),
              f"{what}: non-finite {nm} differ from the plain composition")
        fin = np.isfinite(b)
        err = float(np.max(np.abs(a[fin] - b[fin])
                           / (gof_tol + gof_tol * np.abs(b[fin]))))
        check(err <= 1.0, f"{what}: {nm} differs from the plain "
                          f"composition ({err} x tol)")
    close = np.isclose(got[0], plain[0], rtol=2e-3, atol=2e-5)
    if not close.all():
        key = "cdf_thresh" if cdf else key
        check(key is not None, f"{what}: PDFs differ from the plain "
                               "composition beyond rtol 2e-3 / atol 2e-5")
        rows = np.nonzero(~close.all(axis=1))[0]
        sub_r = tuple(x[rows] for x in sub[:3]) + tuple(sub[3:])
        thr = fp_kw.get(key, WT_THRESH)
        kw = {k: v for k, v in plain_kw.items() if k != key}
        lo = bf.fit_predict(*sub_r, **{key: thr * FLIP}, **kw)[0]
        hi = bf.fit_predict(*sub_r, **{key: thr / FLIP}, **kw)[0]
        tol = 2e-5 + 2e-3 * np.abs(plain[0][rows])
        inside = ((got[0][rows] >= np.minimum(lo, hi) - tol)
                  & (got[0][rows] <= np.maximum(lo, hi) + tol))
        check(inside.all(), f"{what}: PDFs differ from the plain "
                            "composition beyond the threshold-flip envelope")
    return int((~close).sum())


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    sys.path.insert(0, str(HERE))
    try:
        import frankenz_tpu_torch as ft
    except ImportError as exc:
        fail(f"frankenz_tpu_torch is not beside this script: {exc}")
    check(Path(ft.__file__).resolve().parent.parent == HERE,
          "frankenz_tpu_torch was imported from outside this checkout")
    from frankenz_tpu_torch import kernels as KS
    from frankenz_tpu_torch.kernels import build as kbuild
    from frankenz_tpu_torch.kernels import fullmask as FM
    from frankenz_tpu_torch.kernels import general as GK
    from frankenz_tpu_torch.models import BruteForce
    from frankenz_tpu_torch.ops import fused as TF
    from frankenz_tpu_torch.ops import kde as TK
    from frankenz_tpu_torch.ops import summarize as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")

    # 1. environment
    card = card_line()
    print(card, flush=True)
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    # 2. build
    build_s = kbuild.build(force=True)
    kbuild.load()
    print(f"build: nvcc {kbuild.nvcc_path()} -> {kbuild.library_path()} "
          f"in {build_s:.2f} s", flush=True)

    # 3. kernels vs plain (bench.py:316-332's generator)
    rng = np.random.default_rng(0)
    f32 = np.float32
    models = rng.uniform(1, 10, (NMODEL, NFILT)).astype(f32)
    models_err = (0.05 * models).astype(f32)
    zlabels = rng.uniform(0, 3.5, NMODEL)
    zerrs = np.full(NMODEL, 0.1)
    grid = np.linspace(0.0, 4.0, NGRID)
    pdict = TK.PDFDict(grid, np.linspace(0.01, 0.5, 100))
    G = TK.kernel_matrix_dict(pdict, *pdict.fit(zlabels, zerrs),
                              device=dev).to(torch.float32).contiguous()
    data = rng.uniform(1, 10, (N_E2E, NFILT)).astype(f32)
    data_err = np.full((N_E2E, NFILT), 0.25, f32)
    ones_d = np.ones((N_E2E, NFILT), f32)

    def tens(x):
        return torch.tensor(np.ascontiguousarray(x), device=dev)

    rng20 = np.random.default_rng(1)
    m20 = rng20.uniform(1, 10, (NMODEL, 20)).astype(f32)
    d20 = rng20.uniform(1, 10, (1_000, 20)).astype(f32)
    clamped = data[:64].copy()
    clamped[0] = 1e6
    cases = [
        ("config4", data[:N_KERNEL], models, G),
        ("ragged_M99937_B1000", data[:1_000], models[:99_937],
         G[:99_937].contiguous()),
        ("logform_F20", d20, m20, G),
        ("all_clamped_row", clamped, models, G),
    ]
    results = {"chi2_brackets": {}, "chi2_stack": {}}
    wthr = float(np.exp(np.log(WT_THRESH)))
    for name, d_np, m_np, Gc in cases:
        F = d_np.shape[1]
        a1 = 0.5 * F - 1.0
        d, mT = tens(d_np), tens(m_np.T)
        de = tens(np.full(d_np.shape, 0.25, f32))
        meT = tens((0.05 * m_np).astype(f32).T)

        def brackets_k():
            return FM.chi2_brackets(d, de, mT, meT, c0=2 * a1)

        def brackets_p():
            return FM.chi2_brackets_plain(d, de, mT, meT, c0=2 * a1)

        bk, bp = brackets_k(), brackets_p()
        torch.cuda.synchronize()
        errs = [rel_err(torch, g, w) for g, w in zip(bk, bp)]
        b_abs, b_rel = max(e[0] for e in errs), max(e[1] for e in errs)
        check(b_rel <= TOL_BRACKET,
              f"{name}: chi2_brackets differs from plain (rel {b_rel})")
        _, shift = TF.lmap_and_shift(*bp, F)

        def stack_k(thr=wthr):
            return FM.chi2_stack(d, de, mT, meT, Gc, shift, a1=a1, wthr=thr)

        def stack_p(thr=wthr):
            return FM.chi2_stack_plain(d, de, mT, meT, Gc, shift, a1=a1,
                                       wthr=thr)

        (pk, sk), (pp, sp) = stack_k(), stack_p()
        torch.cuda.synchronize()
        s_abs, s_rel = rel_err(torch, sk, sp)
        check(s_rel <= TOL_SUM,
              f"{name}: chi2_stack weight sums differ (rel {s_rel})")
        p_row, ok = pdf_rows_close(torch, pk, pp,
                                   lambda: stack_p(wthr * FLIP)[0],
                                   lambda: stack_p(wthr / FLIP)[0],
                                   TOL_PDF_ROW)
        check(ok, f"{name}: chi2_stack PDFs differ beyond the "
                  f"threshold-flip envelope (row-normwise {p_row})")
        p_abs = float((pk - pp).abs().max())
        t = {"brackets": (median_ms(torch, brackets_k),
                          median_ms(torch, brackets_p)),
             "stack": (median_ms(torch, stack_k),
                       median_ms(torch, stack_p))}
        for kname, ab, rl, key in (("chi2_brackets", b_abs, b_rel,
                                    "brackets"),
                                   ("chi2_stack", max(p_abs, s_abs),
                                    max(p_row, s_rel), "stack")):
            results[kname][name] = dict(max_abs_err=ab, max_rel_err=rl,
                                        ms=t[key][0], plain_ms=t[key][1])
        print(f"kernel_vs_plain {name}: B={d_np.shape[0]} "
              f"M={m_np.shape[0]} F={F} Ngrid={Gc.shape[1]} | "
              f"chi2_brackets abs {b_abs:.3g} rel {b_rel:.3g} "
              f"{t['brackets'][0]:.3f} ms (plain {t['brackets'][1]:.3f} "
              f"ms) | chi2_stack pdf abs {p_abs:.3g} row-rel {p_row:.3g} "
              f"s rel {s_rel:.3g} {t['stack'][0]:.3f} ms (plain "
              f"{t['stack'][1]:.3f} ms) | card {card}", flush=True)
        del d, de, mT, meT, bk, bp, pk, pp
        torch.cuda.empty_cache()

    # 4. end to end through the user entry points
    bf = BruteForce(models, models_err, np.ones_like(models), device="cuda")
    fp_kw = dict(label_dict=pdict, verbose=False, return_gof=True)
    bf.fit_predict(data[:4_096], data_err[:4_096], ones_d[:4_096], zlabels,
                   zerrs, **fp_kw)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    pdfs, (lmap, levid) = bf.fit_predict(data, data_err, ones_d, zlabels,
                                         zerrs, **fp_kw)
    wall = time.perf_counter() - t0
    launches = KS.launch_counts()
    for kname in ("chi2_brackets", "chi2_stack"):
        check(launches[kname] > 0, f"{kname} was not launched by fit_predict")
    check(pdfs.shape == (N_E2E, NGRID), f"pdf shape {pdfs.shape}")
    check(np.isfinite(pdfs).all() and np.isfinite(lmap).all()
          and np.isfinite(levid).all(), "non-finite fit_predict output")
    rows = pdfs.sum(axis=1)
    check(np.all((np.abs(rows - 1.0) <= 1e-4) | (rows == 0.0)),
          "PDF rows do not sum to 1 (or 0)")
    # levid = lmap + log(sum of weights), the largest ~1: one dominant
    # model can leave levid 1 ulp below lmap.
    check(np.all(lmap <= levid + 1e-6 * (1.0 + np.abs(lmap))),
          "lmap > levid")
    rate = N_E2E * NMODEL / wall
    sub = (data[:N_SUBSET], data_err[:N_SUBSET], ones_d[:N_SUBSET], zlabels,
           zerrs)
    plain = bf.fit_predict(*sub, use_fused=False, **fp_kw)
    lm_err = float(np.max(np.abs(lmap[:N_SUBSET] - plain[1][0])
                          / (2e-5 + 2e-5 * np.abs(plain[1][0]))))
    lv_err = float(np.max(np.abs(levid[:N_SUBSET] - plain[1][1])
                          / (2e-5 + 2e-5 * np.abs(plain[1][1]))))
    check(lm_err <= 1.0 and lv_err <= 1.0,
          f"GOF differs from the plain composition (x tol: lmap {lm_err}, "
          f"levid {lv_err})")
    got_sub, want_sub = pdfs[:N_SUBSET], plain[0]
    close = np.isclose(got_sub, want_sub, rtol=2e-3, atol=2e-5)
    if not close.all():
        lo = bf.fit_predict(*sub, use_fused=False,
                            wt_thresh=WT_THRESH * FLIP, **fp_kw)[0]
        hi = bf.fit_predict(*sub, use_fused=False,
                            wt_thresh=WT_THRESH / FLIP, **fp_kw)[0]
        tol = 2e-5 + 2e-3 * np.abs(want_sub)
        inside = ((got_sub >= np.minimum(lo, hi) - tol)
                  & (got_sub <= np.maximum(lo, hi) + tol))
        check(inside.all(), "fit_predict PDFs differ from the plain "
                            "composition beyond the threshold-flip envelope")
    print(f"end_to_end fit_predict: {N_E2E} objects x {NMODEL} models x "
          f"{NGRID} grid, batch {BATCH}: wall {wall:.4f} s, "
          f"{rate:.6g} chi2 pair-evals/s, launches {launches}, subset "
          f"{N_SUBSET} vs plain: {int((~close).sum())} PDF cells outside "
          f"rtol 2e-3 | card {card}", flush=True)

    t0 = time.perf_counter()
    summ, gof = bf.fit_summarize(data, data_err, ones_d, zlabels, zerrs,
                                 label_dict=pdict, verbose=False)
    wall_s = time.perf_counter() - t0
    cols = np.stack([np.asarray(c) for est in summ[:4] for c in est]
                    + [np.asarray(c) for c in summ[4:]], axis=1)
    check(cols.shape == (N_E2E, TS.SUMMARY_NCOLS), "summary shape")
    u = np.random.default_rng(0).random(N_E2E)
    want = TS.pdfs_summarize(torch.tensor(pdfs, device=dev), grid, u=u)
    want_cols = TS._pack_summary(want).cpu().numpy()
    s_err = float(np.max(np.abs(cols - want_cols)
                         / (2e-6 + 2e-5 * np.abs(want_cols))))
    check(s_err <= 1.0, f"fit_summarize differs from pdfs_summarize("
                        f"fit_predict) (x tol {s_err})")
    check(np.array_equal(gof[0], lmap), "fit_summarize lmap differs")
    print(f"end_to_end fit_summarize: wall {wall_s:.4f} s, "
          f"{N_E2E * NMODEL / wall_s:.6g} chi2 pair-evals/s, 21 columns "
          f"match pdfs_summarize(fit_predict) (worst {s_err:.3g} x tol) | "
          f"card {card}", flush=True)

    # kernel times at the main path's batch (no plain version fits there)
    d_b = tens(data[:BATCH])
    de_b = tens(data_err[:BATCH])
    mT, meT = tens(models.T), tens(models_err.T)
    below, above = FM.chi2_brackets(d_b, de_b, mT, meT, c0=NFILT - 2.0)
    _, shift_b = TF.lmap_and_shift(below, above, NFILT)
    ms_a = median_ms(torch, lambda: FM.chi2_brackets(
        d_b, de_b, mT, meT, c0=NFILT - 2.0), reps=3)
    ms_b = median_ms(torch, lambda: FM.chi2_stack(
        d_b, de_b, mT, meT, G, shift_b, a1=0.5 * NFILT - 1.0, wthr=wthr),
        reps=3)
    print(f"kernel_at_batch {BATCH}x{NMODEL}: chi2_brackets {ms_a:.3f} ms, "
          f"chi2_stack {ms_b:.3f} ms | card {card}", flush=True)
    ms_batch = {"chi2_brackets": ms_a, "chi2_stack": ms_b}

    del d_b, de_b, mT, meT, below, above, shift_b
    torch.cuda.empty_cache()

    # 5. masked photometry: the general kernels
    dmask = (np.random.default_rng(2).uniform(size=(N_E2E, NFILT))
             >= P_MISSING).astype(f32)
    n_dead = int((dmask.sum(axis=1) == 0).sum())
    for kname in GENERAL + ("lnl_onepass",):
        results[kname] = {}
    for case in general_cases(np, np.random.default_rng(3), data, models,
                              dmask):
        per = general_kernel_case(torch, np, GK, TF, tens, card, G, case)
        for kname, r in per.items():
            results[kname][case[0]] = r

    sub = (data[:N_SUBSET], data_err[:N_SUBSET], dmask[:N_SUBSET], zlabels,
           zerrs)
    bf.fit_predict(data[:4_096], data_err[:4_096], dmask[:4_096], zlabels,
                   zerrs, **fp_kw)  # warm-up of the general route
    torch.cuda.synchronize()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    pdfs_m, gof_m = bf.fit_predict(data, data_err, dmask, zlabels, zerrs,
                                   **fp_kw)
    wall_m = time.perf_counter() - t0
    launches_m = KS.launch_counts()
    check(launches_m["lnl_reduce"] > 0 and launches_m["lnl_stack"] > 0,
          f"masked fit_predict did not launch the general kernels "
          f"({launches_m})")
    check(launches_m["chi2_brackets"] == launches_m["chi2_stack"] == 0,
          f"masked fit_predict launched the full-mask pair ({launches_m})")
    dead = ~np.isfinite(gof_m[0])
    check(int(dead.sum()) == n_dead and n_dead > 0
          and np.all(pdfs_m[dead] == 0.0)
          and np.all(gof_m[1][dead] == -np.inf),
          f"degenerate rows: {int(dead.sum())} with -inf lmap, "
          f"{n_dead} all-masked")
    check(np.isfinite(pdfs_m).all() and np.isfinite(gof_m[1][~dead]).all(),
          "non-finite masked fit_predict output")
    rows = pdfs_m[~dead].sum(axis=1)
    check(np.all(np.abs(rows - 1.0) <= 1e-4), "PDF rows do not sum to 1")
    off_m = check_vs_plain(np, bf, (pdfs_m[:N_SUBSET],
                                    (gof_m[0][:N_SUBSET],
                                     gof_m[1][:N_SUBSET])),
                           sub, fp_kw, "masked fit_predict")
    print(f"end_to_end masked fit_predict: {N_E2E} objects x {NMODEL} "
          f"models x {NGRID} grid, batch {BATCH}, {n_dead} all-masked rows: "
          f"wall {wall_m:.4f} s, {N_E2E * NMODEL / wall_m:.6g} pair-evals/s, "
          f"launches {launches_m}, subset {N_SUBSET} vs plain: {off_m} PDF "
          f"cells outside rtol 2e-3 | card {card}", flush=True)

    t0 = time.perf_counter()
    summ_m, gof_sm = bf.fit_summarize(data, data_err, dmask, zlabels, zerrs,
                                      label_dict=pdict, verbose=False)
    wall_sm = time.perf_counter() - t0
    cols = np.stack([np.asarray(c) for est in summ_m[:4] for c in est]
                    + [np.asarray(c) for c in summ_m[4:]], axis=1)
    want = TS.pdfs_summarize(torch.tensor(pdfs_m, device=dev), grid, u=u)
    want_cols = TS._pack_summary(want).cpu().numpy()
    check(np.isclose(cols, want_cols, rtol=2e-5, atol=2e-6,
                     equal_nan=True).all(),
          "masked fit_summarize differs from pdfs_summarize(fit_predict)")
    check(np.array_equal(gof_sm[0], gof_m[0]), "fit_summarize lmap differs")
    print(f"end_to_end masked fit_summarize: wall {wall_sm:.4f} s, "
          f"{N_E2E * NMODEL / wall_sm:.6g} pair-evals/s, 21 columns match "
          f"pdfs_summarize(fit_predict) | card {card}", flush=True)
    del pdfs_m, summ_m, cols, want, want_cols

    cdf_kw = dict(fp_kw, wt_thresh=None, cdf_thresh=CDF_THRESH)
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    pdfs_c, gof_c = bf.fit_predict(data[:BATCH], data_err[:BATCH],
                                   dmask[:BATCH], zlabels, zerrs, **cdf_kw)
    wall_c = time.perf_counter() - t0
    launches_c = KS.launch_counts()
    for kname in ("lnl_reduce", "lnl_topk", "lnl_cut_stack"):
        check(launches_c[kname] > 0, f"cdf fit_predict did not launch "
                                     f"{kname} ({launches_c})")
    check(launches_c["lnl_stack"] == launches_c["lnl_reduce_split"] == 0,
          f"cdf fit_predict launched lnl_stack or the bisection "
          f"({launches_c})")
    check(bf.cdf_reruns == 0, f"{bf.cdf_reruns} cdf batches reran")
    off_c = check_vs_plain(np, bf, (pdfs_c[:N_SUBSET],
                                    (gof_c[0][:N_SUBSET],
                                     gof_c[1][:N_SUBSET])),
                           sub, cdf_kw, "cdf fit_predict", cdf=True)
    print(f"end_to_end cdf fit_predict: {BATCH} objects x {NMODEL} models, "
          f"cdf_thresh {CDF_THRESH}: wall {wall_c:.4f} s, launches "
          f"{launches_c}, reruns {bf.cdf_reruns}, subset {N_SUBSET} vs "
          f"plain: {off_c} PDF cells outside rtol 2e-3 | card {card}",
          flush=True)
    del pdfs_c

    # The rerun path: a flat posterior (data errors 1e3, 0.37 off model 0
    # in every band, so no chi^2 is exactly 0) leaves the cut undetermined;
    # the kernel flags it, and BruteForce reruns the batch with the cut
    # found by bisection (34 `lnl_reduce_split` passes).
    flat = (np.tile(models[:1] + f32(0.37), (256, 1)),
            np.full((256, NFILT), 1e3, f32), np.ones((256, NFILT), f32))
    flag = TF.fused_fit_pdf(
        *(tens(x) for x in flat), bf.models, bf.models_err, bf.models_mask,
        G, wt_thresh=None, cdf_thresh=0.999999, cdf_topk=2,
        defer_cdf_check=True)[3]
    check(not bool(flag), "flat posterior (cdf_topk=2) was not flagged")
    launches_r = {}
    for thr in (0.999999, 0.5):
        flat_kw = dict(fp_kw, wt_thresh=None, cdf_thresh=thr)
        KS.reset_launch_counts()
        t0 = time.perf_counter()
        got_f = bf.fit_predict(*flat, zlabels, zerrs, **flat_kw)
        wall_f = time.perf_counter() - t0
        launches_r = KS.launch_counts()
        check(bf.cdf_reruns == 1, f"flat posterior, cdf_thresh {thr}: "
                                  f"{bf.cdf_reruns} reruns")
        for kname in ("lnl_reduce", "lnl_topk", "lnl_reduce_split",
                      "lnl_cut_stack"):
            check(launches_r[kname] > 0, f"flat posterior rerun did not "
                                         f"launch {kname} ({launches_r})")
        off_f = check_vs_plain(np, bf, got_f, (*flat, zlabels, zerrs),
                               flat_kw, f"flat-posterior rerun {thr}",
                               cdf=True)
        kept = int((got_f[0].sum(axis=1) > 0).sum())
        print(f"rerun: flat posterior, cdf_thresh {thr}: flagged, 1 batch "
              f"rerun, wall {wall_f:.4f} s, launches {launches_r}, "
              f"{kept} of 256 rows keep weight, {off_f} PDF cells outside "
              f"rtol 2e-3 of the plain composition | card {card}",
              flush=True)

    # general kernel times at the main path's batch (masked)
    args_b = [tens(x) for x in (data[:BATCH], data_err[:BATCH],
                                dmask[:BATCH], models.T, models_err.T,
                                np.ones_like(models).T)]
    lm_b, lv_b = GK.lnl_reduce(*args_b)
    split_b = lm_b - 3.0
    vals_b, cnts_b = GK.lnl_topk(*args_b, T=8)
    cut_b, tie_b, nkeep_b, _ = TF.cdf_cut(vals_b, cnts_b, lv_b, CDF_THRESH)
    log_thr = float(np.log(WT_THRESH))
    for kname, fn in (
            ("lnl_reduce", lambda: GK.lnl_reduce(*args_b)),
            ("lnl_reduce_split", lambda: GK.lnl_reduce_split(*args_b,
                                                             split_b)),
            ("lnl_stack", lambda: GK.lnl_stack(*args_b, G, lm_b, lv_b,
                                               log_thr=log_thr)),
            ("lnl_topk", lambda: GK.lnl_topk(*args_b, T=8)),
            ("lnl_cut_stack", lambda: GK.lnl_cut_stack(
                *args_b, G, cut_b, lv_b, tie_b, nkeep_b))):
        ms_batch[kname] = median_ms(torch, fn, reps=3)
    print(f"kernel_at_batch {BATCH}x{NMODEL} masked: " + ", ".join(
        f"{k} {ms_batch[k]:.3f} ms" for k in (
            "lnl_reduce", "lnl_reduce_split", "lnl_stack", "lnl_topk",
            "lnl_cut_stack"))
        + f" | card {card}", flush=True)
    # K4: one walk against lnl_reduce + lnl_stack keeping every weight.
    ms_batch["lnl_onepass"] = median_ms(
        torch, lambda: GK.lnl_onepass(*args_b, G), reps=3)

    def reduce_and_stack_all():
        lm, lv = GK.lnl_reduce(*args_b)
        return GK.lnl_stack(*args_b, G, lm, lv, log_thr=-np.inf)

    ms_two = median_ms(torch, reduce_and_stack_all, reps=3)
    print(f"kernel_at_batch {BATCH}x{NMODEL} masked, no weight threshold: "
          f"lnl_onepass {ms_batch['lnl_onepass']:.3f} ms, lnl_reduce + "
          f"lnl_stack keeping every weight {ms_two:.3f} ms | card {card}",
          flush=True)
    del args_b, lm_b, lv_b, split_b, vals_b, cnts_b, cut_b, tie_b, nkeep_b
    torch.cuda.empty_cache()

    # 6. free scale (K6) and the one-pass kernel (K4): every free-scale
    # instantiation against its plain version on config-8 data
    # (bench.py:628-649: noisy copies of the models scaled by U(0.5, 2),
    # so the scale iterates; data errors 0.25, model errors 5%)
    rng8 = np.random.default_rng(0)
    rng8.uniform(1, 10, (NMODEL, NFILT))  # config 8's models: `models`
    scales = rng8.uniform(0.5, 2.0, (N8, 1))
    data8 = (scales * models[rng8.integers(0, NMODEL, N8)]
             + rng8.normal(0, 0.3, (N8, NFILT))).astype(f32)
    zl8 = rng8.uniform(0, 3.5, NMODEL)
    de8 = np.full((N8, NFILT), 0.25, f32)
    ones8 = np.ones((N8, NFILT), f32)
    G8 = TK.kernel_matrix_dict(pdict, *pdict.fit(zl8, zerrs),
                               device=dev).to(torch.float32).contiguous()
    results["scale_sweeps"] = {}
    for kname in GENERAL + ("lnl_onepass",):
        results[kname + "_fs"] = {}
    ones_m = np.ones_like(models)
    for ime in (False, True):
        for fm in (True, False):
            for dp in (True, False):
                cname = (f"fs_{'ime' if ime else 'me'}_"
                         f"{'full' if fm else 'masked'}_"
                         f"{'dimprior' if dp else 'normal'}")
                case = (cname, data8[:N_KERNEL],
                        ones8[:N_KERNEL] if fm else dmask[:N_KERNEL], models,
                        ones_m, dict(full_mask=fm, dim_prior=dp,
                                     ignore_model_err=ime, free_scale=True))
                per = general_kernel_case(torch, np, GK, TF, tens, card, G8,
                                          case, plain_reps=1)
                for kname, r in per.items():
                    key = kname if kname == "scale_sweeps" else kname + "_fs"
                    results[key][cname] = r

    def drive(call, kw, expect, what, absent=()):
        """One `fit_predict` with the launch counts set to 0 just
        before and read just after; returns (out, wall, launches)."""
        KS.reset_launch_counts()
        t0 = time.perf_counter()
        out = bf.fit_predict(*call, **kw)
        wall = time.perf_counter() - t0
        got = KS.launch_counts()
        for kname in expect:
            check(got[kname] > 0, f"{what} did not launch {kname} ({got})")
        for kname in ("chi2_brackets", "chi2_stack", *absent):
            check(got[kname] == 0, f"{what} launched {kname} ({got})")
        return out, wall, got

    def check_rows(pdfs, gof, what, n_dead=0):
        """Finite outputs, -inf GOF and zero PDFs on exactly `n_dead`
        degenerate rows, the others summing to 1 with lmap <= levid."""
        dead = ~np.isfinite(gof[0])
        check(int(dead.sum()) == n_dead and np.all(pdfs[dead] == 0.0)
              and np.all(gof[1][dead] == -np.inf),
              f"{what}: {int(dead.sum())} degenerate rows, {n_dead} expected")
        check(np.isfinite(pdfs).all() and np.isfinite(gof[1][~dead]).all(),
              f"non-finite {what} output")
        rows = pdfs[~dead].sum(axis=1)
        check(np.all(np.abs(rows - 1.0) <= 1e-4), f"{what}: PDF rows do not "
                                                  "sum to 1")
        lm, lv = gof[0][~dead], gof[1][~dead]
        check(np.all(lm <= lv + 1e-6 * (1.0 + np.abs(lm))), f"{what}: lmap "
                                                           "> levid")

    def head(out, n=N_SUBSET):
        return out[0][:n], (out[1][0][:n], out[1][1][:n])

    # Config 8 end to end (bench.py:612-699): 16,384 objects x 100,000
    # models x 301, free scale with model errors, wt_thresh 1e-3, ltol
    # 1e-4, full masks; every row against the plain composition on the
    # card in 2,048-row batches
    call8 = (data8, de8, ones8, zl8, zerrs)
    kw8 = dict(fp_kw, lprob_kwargs=dict(free_scale=True, ltol=1e-4))
    bf.fit_predict(data8[:2_048], de8[:2_048], ones8[:2_048], zl8, zerrs,
                   **kw8)  # warm-up of the free-scale instantiations
    torch.cuda.synchronize()
    out8, wall8, launches8 = drive(
        call8, kw8, ("scale_sweeps", "lnl_reduce", "lnl_stack"),
        "config 8 fit_predict", absent=("lnl_onepass",))
    check_rows(out8[0], out8[1], "config 8 fit_predict")
    mT8 = bf.models.T.contiguous()
    sw8 = GK.scale_sweeps(tens(data8), tens(de8), tens(ones8), mT8,
                          bf.models_err.T.contiguous(),
                          bf.models_mask.T.contiguous(),
                          tm=TF.group_width(NMODEL, 512), full_mask=True)
    t0 = time.perf_counter()
    off8 = check_vs_plain(np, bf, out8, call8, kw8, "config 8 fit_predict",
                          gof_tol=TOL_GOF_FS_ME,
                          plain_kw=dict(batch_size=PLAIN_BATCH_FS))
    wall8_plain = time.perf_counter() - t0
    print(f"end_to_end config 8 fit_predict: {N8} objects x {NMODEL} models "
          f"x {NGRID} grid, free scale, model errors, wt_thresh "
          f"{WT_THRESH}, ltol 1e-4: wall {wall8:.4f} s, "
          f"{N8 * NMODEL / wall8:.6g} pair-evals/s, sweeps per (object, "
          f"512-model group) mean {float(sw8.float().mean()):.4f} max "
          f"{int(sw8.max())}, launches {launches8}; all {N8} rows vs the "
          f"plain composition ({PLAIN_BATCH_FS}-row batches, {wall8_plain:.1f}"
          f" s): {off8} PDF cells outside rtol 2e-3 | card {card}",
          flush=True)
    t0 = time.perf_counter()
    summ8, gof8s = bf.fit_summarize(*call8, label_dict=pdict, verbose=False,
                                    lprob_kwargs=kw8["lprob_kwargs"])
    wall8_s = time.perf_counter() - t0
    cols = np.stack([np.asarray(c) for est in summ8[:4] for c in est]
                    + [np.asarray(c) for c in summ8[4:]], axis=1)
    want = TS.pdfs_summarize(torch.tensor(out8[0], device=dev), grid,
                             u=np.random.default_rng(0).random(N8))
    check(np.isclose(cols, TS._pack_summary(want).cpu().numpy(), rtol=2e-5,
                     atol=2e-6, equal_nan=True).all(),
          "config 8 fit_summarize differs from pdfs_summarize(fit_predict)")
    check(np.array_equal(gof8s[0], out8[1][0]), "config 8 fit_summarize "
                                                "lmap differs")
    print(f"end_to_end config 8 fit_summarize: wall {wall8_s:.4f} s, "
          f"{N8 * NMODEL / wall8_s:.6g} pair-evals/s, 21 columns match "
          f"pdfs_summarize(fit_predict) | card {card}", flush=True)
    del out8, summ8, cols, want
    launches_fs = dict(launches8)

    # Free scale without model errors over one masked 65,536 batch
    # of the config-4 catalog, under each weight selection; rows with
    # fewer than 2 bands have no dof and floor
    call9 = (data[:BATCH], data_err[:BATCH], dmask[:BATCH], zlabels, zerrs)
    n_dead9 = int((dmask[:BATCH].sum(axis=1) < 2).sum())
    lkw9 = dict(free_scale=True, ignore_model_err=True)
    walls9 = {}
    for label, extra, expect in (
            ("wt_thresh", {}, ("lnl_reduce", "lnl_stack")),
            ("cdf", dict(wt_thresh=None, cdf_thresh=CDF_THRESH),
             ("lnl_reduce", "lnl_topk", "lnl_cut_stack")),
            ("none", dict(wt_thresh=None, cdf_thresh=None),
             ("lnl_onepass",))):
        kw9 = dict(fp_kw, lprob_kwargs=lkw9, **extra)
        what = f"free-scale masked fit_predict ({label})"
        bf.fit_predict(*(x[:4_096] for x in call9[:3]), zlabels, zerrs,
                       **kw9)  # warm-up
        torch.cuda.synchronize()
        out9, walls9[label], l9 = drive(
            call9, kw9, expect, what, absent=("scale_sweeps",) + tuple(
                k for k in GENERAL + ("lnl_onepass",) if k not in expect))
        check(bf.cdf_reruns == 0, f"{what}: {bf.cdf_reruns} batches reran")
        check_rows(out9[0], out9[1], what, n_dead9)
        off9 = check_vs_plain(np, bf, head(out9), sub, kw9, what,
                              cdf=label == "cdf",
                              key=None if label == "none" else "wt_thresh",
                              gof_tol=TOL_GOF_FS_IME)
        for kname, n in l9.items():
            launches_fs[kname] += n
        print(f"end_to_end {what}: {BATCH} objects x {NMODEL} models, "
              f"{n_dead9} rows with < 2 bands: wall {walls9[label]:.4f} s, "
              f"{BATCH * NMODEL / walls9[label]:.6g} pair-evals/s, launches "
              f"{l9}, subset {N_SUBSET} vs plain: {off9} PDF cells outside "
              f"rtol 2e-3 | card {card}", flush=True)
        del out9

    # The bisection under free scale: the flat posterior of phase 5
    # under the Normal likelihood (chi^2 ~ 1e-5 for every model) at
    # cdf_thresh 0.5 must rerun through `lnl_reduce_split`.
    flat_kw = dict(fp_kw, wt_thresh=None, cdf_thresh=0.5,
                   lprob_kwargs=dict(lkw9, dim_prior=False))
    got_f, wall_f, l_f = drive(
        (*flat, zlabels, zerrs), flat_kw,
        ("lnl_reduce", "lnl_topk", "lnl_reduce_split", "lnl_cut_stack"),
        "free-scale flat-posterior rerun", absent=("scale_sweeps",))
    check(bf.cdf_reruns == 1, f"free-scale flat posterior: {bf.cdf_reruns} "
                              "reruns")
    off_f = check_vs_plain(np, bf, got_f, (*flat, zlabels, zerrs), flat_kw,
                           "free-scale flat-posterior rerun", cdf=True,
                           gof_tol=TOL_GOF_FS_IME)
    for kname, n in l_f.items():
        launches_fs[kname] += n
    print(f"rerun: free-scale flat posterior (Normal), cdf_thresh 0.5: "
          f"flagged, 1 batch rerun, wall {wall_f:.4f} s, launches {l_f}, "
          f"{off_f} PDF cells outside rtol 2e-3 of the plain composition | "
          f"card {card}", flush=True)

    # Fixed scale with no weight threshold over one masked 65,536
    # batch: the one-pass kernel alone
    kw10 = dict(fp_kw, wt_thresh=None, cdf_thresh=None)
    call10 = (data[:BATCH], data_err[:BATCH], dmask[:BATCH], zlabels, zerrs)
    bf.fit_predict(*(x[:4_096] for x in call10[:3]), zlabels, zerrs,
                   **kw10)  # warm-up
    torch.cuda.synchronize()
    out10, wall10, launches10 = drive(
        call10, kw10, ("lnl_onepass",), "one-pass masked fit_predict",
        absent=("scale_sweeps",) + GENERAL)
    check_rows(out10[0], out10[1], "one-pass masked fit_predict",
               int((dmask[:BATCH].sum(axis=1) == 0).sum()))
    off10 = check_vs_plain(np, bf, head(out10), sub, kw10,
                           "one-pass masked fit_predict", key=None)
    print(f"end_to_end one-pass masked fit_predict: {BATCH} objects x "
          f"{NMODEL} models x {NGRID} grid, no weight threshold: wall "
          f"{wall10:.4f} s, {BATCH * NMODEL / wall10:.6g} pair-evals/s, "
          f"launches {launches10}, subset {N_SUBSET} vs plain: {off10} PDF "
          f"cells outside rtol 2e-3 | card {card}", flush=True)
    del out10

    # free-scale kernel times at config 8's batch
    args8 = [tens(data8), tens(de8), tens(ones8), mT8,
             bf.models_err.T.contiguous(), bf.models_mask.T.contiguous()]
    fl8 = dict(full_mask=True, free_scale=True, sweeps=sw8,
               tm=TF.group_width(NMODEL, 512))
    lm8, lv8 = GK.lnl_reduce(*args8, **fl8)
    for kname, fn in (
            ("scale_sweeps", lambda: GK.scale_sweeps(
                *args8, tm=fl8["tm"], full_mask=True)),
            ("lnl_reduce_fs", lambda: GK.lnl_reduce(*args8, **fl8)),
            ("lnl_stack_fs", lambda: GK.lnl_stack(
                *args8, G8, lm8, lv8, log_thr=log_thr, **fl8)),
            ("lnl_onepass_fs", lambda: GK.lnl_onepass(*args8, G8, **fl8))):
        ms_batch[kname] = median_ms(torch, fn, reps=3)
    print(f"kernel_at_batch {N8}x{NMODEL} config 8: " + ", ".join(
        f"{k} {ms_batch[k]:.3f} ms" for k in (
            "scale_sweeps", "lnl_reduce_fs", "lnl_stack_fs",
            "lnl_onepass_fs")) + f" | card {card}", flush=True)
    del args8, lm8, lv8, sw8

    # 7. results
    replaces = {"chi2_brackets": "frankenz_tpu/ops/fused.py:918",
                "chi2_stack": "frankenz_tpu/ops/fused.py:980",
                "lnl_reduce": "frankenz_tpu/ops/fused.py:599",
                # No Pallas kernel: the JAX fitter's XLA-sort rerun.
                "lnl_reduce_split": "frankenz_tpu/models/bruteforce.py:852",
                "lnl_stack": "frankenz_tpu/ops/fused.py:634",
                "lnl_topk": "frankenz_tpu/ops/fused.py:721",
                "lnl_cut_stack": "frankenz_tpu/ops/fused.py:779",
                "lnl_onepass": "frankenz_tpu/ops/fused.py:670"}
    main_launches = {"chi2_brackets": launches["chi2_brackets"],
                     "chi2_stack": launches["chi2_stack"],
                     "lnl_reduce": launches_m["lnl_reduce"],
                     "lnl_reduce_split": launches_r["lnl_reduce_split"],
                     "lnl_stack": launches_m["lnl_stack"],
                     "lnl_topk": launches_c["lnl_topk"],
                     "lnl_cut_stack": launches_c["lnl_cut_stack"],
                     "lnl_onepass": launches10["lnl_onepass"]}
    # The free-scale instantiations (csrc/lnl_freescale.cu: the `_fs`
    # entry points and the sweep counts) replace the same Pallas kernels
    # with `_lnl_tile`'s free-scale branch (ops/fused.py:316-596); their
    # launches are those of the free-scale runs (config 8, the masked
    # batch under three weight selections, the flat-posterior rerun).
    replaces["scale_sweeps"] = "frankenz_tpu/ops/fused.py:452"
    main_launches["scale_sweeps"] = launches_fs["scale_sweeps"]
    for kname in GENERAL + ("lnl_onepass",):
        replaces[kname + "_fs"] = replaces[kname]
        main_launches[kname + "_fs"] = launches_fs[kname]
    kernels = []
    for kname in replaces:
        per = results[kname]
        free = kname == "scale_sweeps" or kname.endswith("_fs")
        ref = per["config4" if kname.startswith("chi2") else
                  "fs_me_full_dimprior" if free else "masked_dimprior"]
        check(main_launches[kname] > 0,
              f"{kname} was launched no time by the end-to-end runs")
        entry = {
            "name": kname, "route": "cuda",
            "source": ("frankenz_tpu_torch/csrc/chi2_fullmask.cu"
                       if kname.startswith("chi2") else
                       "frankenz_tpu_torch/csrc/lnl_freescale.cu" if free
                       else "frankenz_tpu_torch/csrc/lnl_general.cu"),
            "replaces": replaces[kname], "launches": main_launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in per.values()),
            "ms": ref["ms"], "plain_ms": ref["plain_ms"],
            "cases": per}
        if kname in ms_batch:
            entry[f"ms_batch_{N8 if free else BATCH}"] = ms_batch[kname]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
