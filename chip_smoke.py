#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`frankenz_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (or any
sm_90a card), `nvcc` and PyTorch built for CUDA.  It imports only the
port, numpy and scipy, and:

1. prints the card (`nvidia-smi` name and power limit) and versions;
2. builds the CUDA kernels from ``frankenz_tpu_torch/csrc`` (timed);
3. holds each kernel against its plain PyTorch version on the card, at
   the config-4 widths (F=5, 100,000 models, a 301-point PDFDict grid,
   2,048 objects) and three edge shapes (ragged M=99,937 with B=1,000;
   F=20, the log-form weight; an all-clamped outlier row), with times of
   both (CUDA events, median of 5);
4. drives `BruteForce.fit_predict` over 131,072 objects (two 65,536-object
   batches x 100,000 models x 301 grid points) with the launch counters
   reset just before, checks the output, checks 1,024 rows against the
   plain composition on the card, and checks `fit_summarize` against
   `pdfs_summarize(fit_predict(...))` under the same uniforms;
5. prints one JSON line of kernel results, the card line again, and last
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


def pdf_rows_close(torch, got, want, lo, hi, tol):
    """Row-normwise closeness, or inside the threshold-flip envelope
    [min(lo, hi), max(lo, hi)] (+- tol of the row maximum)."""
    scale = want.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    err = (got - want).abs() / scale
    if float(err.max()) <= tol:
        return float(err.max()), True
    env_lo = torch.minimum(lo, hi) - tol * scale
    env_hi = torch.maximum(lo, hi) + tol * scale
    inside = bool(((got >= env_lo) & (got <= env_hi)).all())
    return float(err.max()), inside


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
    from frankenz_tpu_torch.kernels import build as kbuild
    from frankenz_tpu_torch.kernels import fullmask as FM
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
        p_row, ok = pdf_rows_close(torch, pk, pp, stack_p(wthr * FLIP)[0],
                                   stack_p(wthr / FLIP)[0], TOL_PDF_ROW)
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
    FM.reset_launch_counts()
    t0 = time.perf_counter()
    pdfs, (lmap, levid) = bf.fit_predict(data, data_err, ones_d, zlabels,
                                         zerrs, **fp_kw)
    wall = time.perf_counter() - t0
    launches = FM.launch_counts()
    for kname, n in launches.items():
        check(n > 0, f"{kname} was not launched by fit_predict")
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

    # 5. results
    replaces = {"chi2_brackets": "frankenz_tpu/ops/fused.py:918",
                "chi2_stack": "frankenz_tpu/ops/fused.py:980"}
    ms_batch = {"chi2_brackets": ms_a, "chi2_stack": ms_b}
    kernels = []
    for kname in ("chi2_brackets", "chi2_stack"):
        per = results[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "frankenz_tpu_torch/csrc/chi2_fullmask.cu",
            "replaces": replaces[kname], "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in per.values()),
            "ms": per["config4"]["ms"],
            "plain_ms": per["config4"]["plain_ms"],
            "ms_batch_65536": ms_batch[kname],
            "cases": per})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
