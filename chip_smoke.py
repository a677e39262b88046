#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`frankenz_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (or any
sm_90a card), `nvcc` and PyTorch built for CUDA.  It imports only the
port, numpy and scipy, and:

1. prints the card (`nvidia-smi` name and power limit) and versions;
2. builds the CUDA kernels from ``frankenz_tpu_torch/csrc`` (timed), and
   prints `nvcc -Xptxas -v`'s registers, spills and stack for the
   screened passes A and B, with their dynamic shared memory; then the
   cluster probe (`kernels.probe`): one cluster barrier round, one DSMEM
   load and the two in a dependent loop of 40,000 rounds at cluster sizes
   2, 4, 8 and 16, and the clusters the card holds at once at the launch
   shapes of phases 8, 9 and 10's cluster routes;
3. holds each full-mask kernel against its plain PyTorch version on the
   card, at the config-4 widths (F=5, 100,000 models, a 301-point
   PDFDict grid, 2,048 objects) and three edge shapes (ragged M=99,937
   with B=1,000; F=20, the log-form weight; an all-clamped outlier row),
   with times of both (CUDA events, median of 5); pass B as the K1 route
   runs it, over the models in band order (`band_sort`, each 64-model
   tile multiplying only its band of G), against its plain version and
   bit for bit the dense kernel on the same order, timed beside the
   caller order's, the brackets in band order bit-equal to the caller
   order's;
3b. the screened full-mask trio (K2: `screen_seed`,
   `chi2_brackets_screened`, `chi2_stack_screened`), the default
   full-mask route: first where the card's expf flushes to 0 (every
   float32 in [-110, -100] through the kernels' own expf and torch.exp,
   which must flush everything at or below the underflow cut); each
   kernel against its plain version on phase 3's four cases, sorted and
   bounded by the route's glue (512-model subtiles, 32-object blocks),
   with times of both, the brackets also equal to the K1 pair's; then
   `fused_fit_pdf` on one 65,536-object batch and the edge cases, under
   wt_thresh 1e-3 and None: screened == run-all and absorption on == off
   bit for bit, lmap == the K1 route's bit for bit, levid (2e-5) and PDFs
   (rtol 2e-3 / atol 2e-5) against it, the run fractions printed;
4. drives `BruteForce.fit_predict` over 131,072 objects (two 65,536-object
   batches x 100,000 models x 301 grid points) with the launch counters
   reset just before (the screened trio must launch, the K1 pair not),
   checks the output, checks 1,024 rows against the plain composition on
   the card, and checks `fit_summarize` against
   `pdfs_summarize(fit_predict(...))` under the same uniforms; then one
   65,536-object batch through `fused_fit_pdf(screen=False)`, the K1
   pair in band order, beside the screened route on the same batch (both
   walls), and every full-mask kernel's time at that batch (`chi2_stack`
   in band order, the caller order's beside), with the screened trio's
   bounds from that batch's run fractions and kept weights;
5. masked photometry (each data band missing with probability 0.15, from
   ``default_rng(2)``: about 10 of the 131,072 rows lose every band):
   first the band order of config 4's G (`band_sort`: its time, the mean
   and widest band of a 64-model tile, the share of nonzero (64-model,
   32-column) blocks in the caller's and in band order and of (64, 128)
   blocks in band order, the band kernels' shared memory and blocks an
   SM); then holds the general kernels against their plain versions at
   B=2,048 on six cases (masked dim prior; model masks too; the Normal
   likelihood on full masks; ragged M=99,937 with B=1,000; rows with Ndim
   0, 1 and 2; duplicate models, whose lnl ties; the cdf mode's
   `lnl_reduce_topk` also with lmap and levid bit-equal to the
   `lnl_reduce` kernel's), on each the two-pass threshold route on its lnl
   table over the models in band order (the producer on the sorted
   models, the band reader `lnl_stack_band`) against the recompute route
   on the same order bit for bit (lmap, levid, pdf; the table against
   `lnl_tile_plain` in ulps), the band reader against its plain version,
   timed beside the dense reader `lnl_stack_read` on a caller-order table,
   also on the four fixed-scale two-pass instantiations the cases do not
   hold, and the band stacks
   (`lnl_cut_stack`, `lnl_onepass`, over the models in band order) on the
   six fixed-scale instantiations the cases do not hold, then drives
   masked `fit_predict` over the 131,072 objects (the general route's
   table route: `lnl_reduce` writing the lnl table over the models in
   band order + `lnl_stack_band` reading it, two row chunks a batch, and
   neither the dense `lnl_stack` nor the full-mask pair),
   `fit_summarize`, the cdf mode over one 65,536-object batch
   (`lnl_reduce_topk` + `lnl_cut_stack`, and no `lnl_reduce` or
   `lnl_topk`; no batch rerun), and a flat-posterior batch whose cut is
   undetermined at cdf_thresh 0.999999 and 0.5 (it must rerun, find the
   cut by bisection with `lnl_reduce_split`, and agree with the plain
   composition); one-pass (`lnl_onepass`) joins each of the six cases, and
   at the batch it is timed beside `lnl_reduce` + `lnl_stack` keeping
   every weight; one 65,536-object batch through the two-pass threshold
   route on both routes (the table route in its row chunks, band order),
   bit for bit, with each route's times, the dense reader on the caller
   order's table beside, and the product alone (`fp32_matmul` of dense
   weights by G) as a yardstick;
6. free scale (K6) and no weight threshold (K4): every free-scale
   instantiation (model errors or not x full or masked x dim prior or
   Normal) against its plain version at B=2,048 on config-8 data
   (bench.py:628-649: scaled noisy model copies), the sweep tables equal,
   and the table route against the recompute route as in phase 5;
   config 8 end to end (16,384 objects, free scale with model errors,
   wt_thresh 1e-3, ltol 1e-4: the table route, `scale_sweeps` writing the
   lnl table + `lnl_reduce` + `lnl_stack` reading it), every row against
   the plain composition in 2,048-row batches, and `fit_summarize`; free
   scale without model errors over
   one masked 65,536 batch under wt_thresh, the cdf mode and no
   threshold (one-pass), and a flat-posterior batch that reruns through
   the bisection; fixed scale with no threshold over one masked batch
   (`lnl_onepass` alone);
7. config 8's batch (16,384 rows, one chunk) through the two-pass
   threshold route on both routes, bit for bit (the sweep table too),
   with each route's `scale_sweeps`, `lnl_reduce` and `lnl_stack` times;
   `lnl_onepass` timed;
8. SOM (config 3 without GNG, bench.py:164-215: 100,000 models over 5
   filters, a 50 x 50 lattice, 100,000 training steps, seed 1):
   `SelfOrganizingMap.train_network` on the `som_train` kernel's cluster
   route with the launch counters reset just before (one cluster launch,
   no block launch); the kernel against its plain version over a
   10,000-step run (niter 200: the same best node at every step, nodes
   within 1e-6 relative) and over the whole 100,000-step run, whose two
   maps must give mean best-node lmaps (from `populate_network`) within
   1%; the whole run on the cluster route and on one block (cluster=1),
   bit-equal on the nodes and all 100,000 best nodes, both timed (CUDA
   events, median of 3), with K, the CTA's threads and shared bytes, us a
   step and the step's floor (one cluster barrier and one DSMEM load at K,
   `kernels.probe`); `populate_network` timed;
   nodes-only `fit_predict` over 10,000 objects in 2,048-object batches
   (warm repeats, against fit + predict); the exact-union `fit_predict`
   over 2,048 objects against fit + predict; `fit_summarize`;
9. GNG (config 3's other half, bench.py:164-172, :201-209: phase 8's
   model set, 5,000 x 50 steps up to 2,500 nodes, seed 2):
   `GrowingNeuralGas.train_network` cold and then warm on the `gng_train`
   kernel's cluster route, with the launch counters reset just before the
   warm run; the kernel timed over the whole run on the cluster route and
   on one block (cluster=1), the two bit-equal, and held bit for bit
   against its
   plain version on every state array over the first 20,000 steps, over
   2,000 steps from the kernel's own state at step 200,000 and on a hub
   whose full slots drop edges; the run cut at step 200,000, and in 8
   segments, equal to one launch; `populate_network` and nodes-only
   `fit_predict` over phase 8's 10,000 objects (warm repeats, against
   fit + predict);
10. the samplers (config 5, bench.py:218-254: 50 bins x 20,000 objects,
   Gaussian PDFs of width 1.5 around redshifts drawn from a bump at bin
   18, ``default_rng(0)``): `population_sampler.run_mcmc(100, thin=400,
   mh_steps=3, seed=0)` cold and then warm on the `pop_chain` kernel's
   cluster route (40,000 Gibbs steps, 120,000 proposals, one launch), with
   the launch counters reset just before the warm run; the kernel timed
   over the whole chain on the cluster route and on one block
   (cluster=1), the two bit-equal, and held bit for bit against its plain
   version on
   samples, lnpost and the carry (the whole chain when the plain version
   takes under about 60 s, else the first 10,000 steps and 2,000 from
   the kernel's carry at step 30,000: on an H100 host the plain version
   takes ~3 ms a step, so the split), on four chains in one launch, on
   a problem with zero overlaps and moves to negative bins, and on the
   non-resident variant; `sample(block=7)` equal to the stored chain;
   the chain's lnpost, simplex and posterior mean checked, the carried
   overlap's drift printed; the general route under a Dirichlet prior,
   its 2,000 steps in float64 on the card held at 1e-6 against the same
   loop on CPU tensors (50 steps at a time from the CPU's carry), and
   under the flat prior beside the kernel route until the two part; `hierarchical_sampler.run_mcmc(200, thin=5, seed=0)` cold and
   warm, and once with a reference sample;
11. config 2 (bench.py:112-160), which runs no kernel of its own (the
   kNN search, union, posterior and KDE are torch on the card):
   `make_sdss_mock(113,000, seed=13)` with the synthesis on the card
   (timed; 4,096 (z, template) pairs held against the CPU at 1e-10 in
   float64), `NearestNeighbors(K=25, seed=1)` over the first 100,000
   (features against the CPU's at 1e-6), the 4,096-object warm call,
   then `fit_predict` over the next 10,000 with a 701-point grid and
   k=20, three walls from ``default_rng(7)`` (bit-equal to each other and
   to ``approx=True``), sigma_NMAD and the outlier fraction as bench.py
   computes them; 512 of those objects against the CPU with the same
   draws, the card's ensembles and query features, on every row
   (neighbour lists equal on 99% of rows, the rest only among near ties,
   `knn._near_ties`; union sizes equal; PDFs, lmap, levid at rtol 2e-3 /
   atol 2e-5 and 2e-5 within the threshold-flip envelope), and, as a
   printed statistic, the rows each device's own inputs move; `fit_summarize` against `pdfs_summarize`
   of the PDFs; the tie case (64 models x 4 copies, zero errors: the
   lowest index first);
12. prints one JSON line of kernel results (fixed-scale entry points by
   their wrapper's name, the screened trio with its run fractions,
   free-scale ones with the suffix ``_fs``; `lnl_reduce`,
   `lnl_stack_band`, `lnl_stack_fs` and `scale_sweeps` with their table
   route (``lnl_route``, the table's source file, table launches, chunks
   and bytes at the batch, the recompute route's times and bounds beside;
   the fixed-scale dense `lnl_stack` runs on no main path and has no entry:
   it stands as ``dense_ms`` beside `lnl_stack_band`),
   `scale_sweeps`, `som_train`, `som_train_cluster` (the route
   train_network takes, with its CTA and the step's floor), `gng_train`
   and `pop_chain`, the chain kernels with their cluster size, us a step
   and the block route's time), each
   with its bound
   (the larger of its bytes over 3.35 TB/s and its operations over 67
   TFLOP/s, counted from this run's shapes and data, see `bound`; the
   band stacks `lnl_cut_stack` and `lnl_onepass`, source
   ``csrc/lnl_band.cuh``, the band reader `lnl_stack_band` and the K1
   pair's `chi2_stack` count 2 operations per nonzero G entry of each
   kept model, the dense count of 2 Ngrid a kept pair beside it as
   ``dense_bound_ms``, and carry the band statistics), the
   card line again, and last ``{"ok": true, "device": {...}}``.

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
GENERAL = ("lnl_reduce", "lnl_reduce_split", "lnl_stack", "lnl_stack_band",
           "lnl_reduce_topk", "lnl_cut_stack")
# The band stacks (csrc/lnl_band.cuh): the models in band order.
BAND = ("lnl_cut_stack", "lnl_onepass")
K1_PAIR = ("chi2_brackets", "chi2_stack")
SCREENED = ("screen_seed", "chi2_brackets_screened", "chi2_stack_screened")
# Free scale end to end against the plain composition: JAX's own GOF
# tolerances, tests/test_fused.py:145-150 (datum-only variance, 1e-4)
# and :182-187 (model errors kept, 1e-3: the kernels converge the scale
# per (object, 512-model group), the plain likelihood per object over
# every model).  Config 8 (bench.py:612-699): objects per batch.
TOL_GOF_FS_IME = 1e-4
TOL_GOF_FS_ME = 1e-3
N8 = 16_384
PLAIN_BATCH_FS = 2_048
# Config 3's SOM half (bench.py:164-215): models, lattice side, steps,
# fit objects and their batch, label grid points.
N3, NSIDE3, NITER3, NBATCH3 = 100_000, 50, 2_000, 50
N3_FIT, BATCH3, NGRID3 = 10_000, 2_048, 321
N3_UNION = 2_048
NITER3_CHECK = 200
TOL_SOM_NODES = 1e-6
TOL_SOM_LMAP = 0.01
# Config 3's GNG half (bench.py:164-172, :201-209): 5,000 x 50 steps up
# to 2,500 nodes, seed 2.  The plain version takes ~1 ms per step on the
# card, so it runs the first PREFIX_G steps and TAIL_G steps from the
# kernel's state at step MID_G, not the whole run.
NITER_G, NMAX_G, SEED_G = 5_000, 2_500, 2
PREFIX_G, MID_G, TAIL_G, SEGS_G = 20_000, 200_000, 2_000, 8
# Config 5 (bench.py:218-254): bins, objects, the population run and the
# hierarchical run.  The plain version runs the whole chain when its first
# PREFIX_P steps project under PLAIN_BUDGET_P seconds, else those steps and
# TAIL_P steps from the kernel's carry at step MID_P.
NBINS5, NOBS5 = 50, 20_000
NITER_P, THIN_P, MH_P, SEED_P = 100, 400, 3, 0
PREFIX_P, MID_P, TAIL_P, PLAIN_BUDGET_P = 10_000, 30_000, 2_000, 60.0
BLOCK_P, NCHAINS_P, NITER_P4, NITER_PG, SEG64_P = 7, 4, 10, 5, 50
NITER_H, THIN_H = 200, 5
# Config 2 (bench.py:112-160): mock objects, train / test split, label
# grid points, ensembles and neighbours; synthesis pairs held against the
# CPU, objects of fit_predict held against the CPU.
N2_MOCK, N2_TRAIN, N2_TEST, N2_GRID = 113_000, 100_000, 10_000, 701
N2_K, N2_KNN, N2_SYNTH, N2_CHECK = 25, 20, 4_096, 512
# The card's peaks for the bounds (H100 SXM datasheet: dense float32
# outside the tensor cores, HBM3).
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# The table route's kernels on the main path (the two-pass threshold
# route): the fixed-scale producer is `lnl_reduce_store` (lnl_common.cuh,
# instantiated in lnl_general.cu), the free-scale one `scale_sweeps`; the
# readers are in lnl_table.cu.
TABLE_SOURCES = {
    "lnl_reduce": "frankenz_tpu_torch/csrc/lnl_general.cu",
    "lnl_stack_band": "frankenz_tpu_torch/csrc/lnl_table.cu",
    "lnl_stack_band_fs": "frankenz_tpu_torch/csrc/lnl_table.cu",
    "lnl_reduce_fs": "frankenz_tpu_torch/csrc/lnl_table.cu",
    "lnl_stack_fs": "frankenz_tpu_torch/csrc/lnl_table.cu",
    "scale_sweeps": "frankenz_tpu_torch/csrc/lnl_freescale.cu"}


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


def bound(ops, nbytes):
    """(ms, what bounds it): the least time for `ops` float32 operations
    and `nbytes` bytes (each input read once, each output written once)
    at the card's peaks."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def lnl_pair_ops(F, flags, sweeps_mean=0.0):
    """Operations of one (object, model) lnl, a divide, log or exp
    counted as one: fixed scale 7 per filter on full masks (variance 2,
    1/var, residual, square, times 1/var, sum), 9 masked (mask product,
    Ndim count), +1 per filter for the Normal's log variance, and ~6 for
    the dim-prior or Normal tail; free scale without model errors 12 per
    filter + 8 (the sums, the ML scale, the residual pass); with model
    errors each scale sweep adds 8 per filter + 2."""
    full = flags.get("full_mask", False)
    if flags.get("free_scale"):
        ops = 12 * F + 8
        if not flags.get("ignore_model_err"):
            ops += sweeps_mean * (8 * F + 2)
        return ops
    ops = (7 if full else 9) * F + 6
    if not flags.get("dim_prior", True):
        ops += F
    return ops


# `lnl_reduce_topk`'s operations a pair past its lnl: `lnl_reduce`'s max,
# subtract, exp and add (4) and the list's two compares (the floor, then
# the list's smallest slot).
REDUCE_TOPK_OPS = 6


def general_bounds(torch, np, GK, TF, args, G, flags, want, log_thr, cut,
                   tie, nkeep, sweeps_mean, lnl):
    """{kernel: (bound ms, bound by)} of one general case: lnl per pair
    plus each kernel's own work, the stacks' 2 Ngrid operations for each
    pair whose weight they keep and is nonzero (counted from the plain lnl
    grid `lnl`).
    `lnl_reduce`, `lnl_stack` and `scale_sweeps` on the table route (the
    two-pass threshold route's): the producer also writes 4 bytes a
    pair, the readers read them and compute no lnl (`table_bounds`).  The
    band stacks (`lnl_cut_stack`, `lnl_onepass`) and the band reader
    `lnl_stack_band`: 2 operations per nonzero G entry of each kept
    model; ``*_dense`` the dense count."""
    d, mT = args[0], args[3]
    B, F = d.shape
    M = mT.shape[1]
    ngrid = G.shape[1]
    lmap, levid = want
    kept_stack = float((lnl > (lmap + float(np.float32(log_thr)))[:, None])
                       .sum())
    is_tie = lnl == tie[:, None]
    rank = torch.cumsum(is_tie.to(torch.int32), dim=1) - 1
    # The band stacks' products: 2 operations per nonzero G entry of each
    # kept model (JAX's `band_stack_products` idea), beside the dense
    # count of 2 Ngrid per kept pair.
    # A pair counts only where its weight is nonzero: a kept weight
    # exp(lnl - levid) that underflows to 0 adds nothing.
    nnz = (G != 0).sum(dim=1).to(torch.float32)
    keep_stack = ((lnl > (lmap + float(np.float32(log_thr)))[:, None])
                  & (torch.exp(lnl - levid[:, None]) > 0))
    band_stack = float((keep_stack.to(torch.float32) @ nnz).sum())
    del keep_stack
    keep_cut = (((lnl <= cut[:, None]) | (is_tie & (rank < nkeep[:, None])))
                & (torch.exp(lnl - levid[:, None]) > 0))
    kept_cut = float(keep_cut.sum())
    band_cut = float((keep_cut.to(torch.float32) @ nnz).sum())
    keep_all = torch.exp(lnl - lmap[:, None]) > 0
    kept_all = float(keep_all.sum())
    band_all = float((keep_all.to(torch.float32) @ nnz).sum())
    del is_tie, rank, keep_cut, keep_all
    pairs = float(B) * M
    base = lnl_pair_ops(F, flags, sweeps_mean)
    io = 4.0 * (3 * B * F + 3 * F * M)
    if flags.get("sweeps") is not None:
        io += 2.0 * flags["sweeps"].numel()
    g_bytes = 4.0 * (M * ngrid + B * ngrid)
    out = {
        "lnl_reduce": bound(pairs * (base + 4), io + 8.0 * B),
        "lnl_reduce_split": bound(pairs * (base + 6), io + 16.0 * B),
        # The outputs: 8 bytes a row and 2 T floats (T = 8).
        "lnl_reduce_topk": bound(pairs * (base + REDUCE_TOPK_OPS),
                                 io + 72.0 * B),
        "lnl_stack": bound(pairs * (base + 3) + 2.0 * ngrid * kept_stack,
                           io + g_bytes + 8.0 * B),
        "lnl_cut_stack": bound(pairs * (base + 4) + 2.0 * band_cut,
                               io + g_bytes + 16.0 * B),
        "lnl_onepass": bound(pairs * (base + 6) + 2.0 * band_all,
                             io + g_bytes + 8.0 * B),
        "lnl_cut_stack_dense": bound(
            pairs * (base + 4) + 2.0 * ngrid * kept_cut,
            io + g_bytes + 16.0 * B),
        "lnl_onepass_dense": bound(pairs * (base + 6) + 2.0 * ngrid * kept_all,
                                   io + g_bytes + 8.0 * B),
    }
    if sweeps_mean:
        # The counting sweeps also take each pair's F logs.
        out["scale_sweeps"] = bound(pairs * sweeps_mean * (9 * F + 4),
                                    io + 2.0 * flags["sweeps"].numel())
    for k, v in table_bounds(F, B, M, ngrid, flags, kept_stack, sweeps_mean,
                             band_stack, float(nnz.sum())).items():
        out[k if k.startswith("lnl_stack_band") else k + "_table"] = v
    return out


def table_bounds(F, B, M, ngrid, flags, kept, sweeps_mean, kept_nnz=None,
                 g_nnz=None):
    """{kernel: (bound ms, bound by)} on the table route for B x M pairs,
    `kept` of them above the weight threshold: the producer (`lnl_reduce`,
    or `scale_sweeps` under free scale with model errors, whose pairs
    also take the residual pass) writes 4 bytes a pair; the reduce reader
    reads them (a max, an exp and two adds a pair); the stack reads them
    (a compare a pair; an exp and 2 Ngrid operations a kept pair).  Off
    free scale with model errors, given `kept_nnz` (the nonzero G entries
    of the kept pairs' models) and `g_nnz` (G's nonzero entries, each read
    once), also the band reader `lnl_stack_band`: 2 operations per
    nonzero G entry of each kept model, and the dense count beside
    (``lnl_stack_band_dense``)."""
    pairs = float(B) * M
    io = 4.0 * (3 * B * F + 3 * F * M)
    table = 4.0 * pairs
    out = {"lnl_stack": bound(pairs + kept * (2.0 + 2.0 * ngrid),
                              table + 4.0 * (M * ngrid + B * ngrid)
                              + 8.0 * B)}
    sweep_policy = flags.get("free_scale") and not flags.get(
        "ignore_model_err")
    if kept_nnz is not None and not sweep_policy:
        out["lnl_stack_band"] = bound(pairs + 2.0 * kept + 2.0 * kept_nnz,
                                      table + 4.0 * (g_nnz + B * ngrid)
                                      + 8.0 * B)
        out["lnl_stack_band_dense"] = out["lnl_stack"]
    if sweep_policy:
        ng = -(-M // int(flags["tm"]))
        out["scale_sweeps"] = bound(
            pairs * (sweeps_mean * (9 * F + 4) + lnl_pair_ops(
                F, dict(flags, ignore_model_err=True))),
            io + 2.0 * B * ng + table)
        out["lnl_reduce"] = bound(pairs * 4, table + 8.0 * B)
    else:
        out["lnl_reduce"] = bound(pairs * (lnl_pair_ops(F, flags) + 4),
                                  io + table + 8.0 * B)
    return out


def table_route(torch, GK, args, G, flags, log_thr, sweep_kw=None, bs=None):
    """The two-pass threshold route on one lnl table (NaN-filled first):
    the producer (`lnl_reduce`, or `scale_sweeps` under free scale with
    model errors), `lnl_reduce`, then `lnl_stack`, or with `bs` (the
    models of `args` in band order) `lnl_stack_band`.  Returns (sweeps or
    None, lmap, levid, pdf, table)."""
    B, M = args[0].shape[0], args[3].shape[1]
    table = torch.full((B, GK.table_width(M)), float("nan"),
                       device=args[0].device)
    fl, sw = dict(flags), None
    if sweep_kw is not None:
        sw = GK.scale_sweeps(*args, table=table,
                             dim_prior=flags.get("dim_prior", True),
                             **sweep_kw)
        fl.update(sweeps=sw, tm=sweep_kw["tm"])
    lmap, levid = GK.lnl_reduce(*args, table=table, **fl)
    if bs is None:
        pdf = GK.lnl_stack(*args, G, lmap, levid, log_thr=log_thr,
                           table=table, **fl)
    else:
        pdf = GK.lnl_stack_band(table, bs, lmap, levid, log_thr=log_thr)
    return sw, lmap, levid, pdf, table


def band_args(GK, args, G):
    """`args`' models in band order: (the argument list with the sorted
    model arrays, G's sorted rows contiguous (M, Ngrid), the BandSort)."""
    bs = GK.band_sort(G, *args[3:6])
    M = args[3].shape[1]
    return (list(args[:3]) + [bs.mT, bs.meT, bs.mmT],
            bs.G[:M, :bs.ngrid].contiguous(), bs)


def table_route_check(torch, np, GK, args, G, flags, log_thr, what,
                      sweep_kw=None, lnl_plain=None):
    """The table route against the recompute route (the same wrappers
    without a table, on the same model order) bit for bit: sweep table,
    lmap, levid, pdf; the table untouched past M and, against `lnl_plain`
    (or `lnl_tile_plain`), within TOL_ULP (the entries that differ
    counted).  Off free scale with model errors both run over the models
    in band order, the route reading with `lnl_stack_band`, as
    `fused_fit_pdf` does.  Returns (route outputs, {"table_ulp",
    "table_ulp_count"}, band-order (args, G, BandSort) or None)."""
    fl = dict(flags)
    band = None
    if sweep_kw is None:
        band = band_args(GK, args, G)
        args, G = band[:2]
        if lnl_plain is not None:
            lnl_plain = lnl_plain[:, band[2].perm.long()]
    sw_r = None
    if sweep_kw is not None:
        sw_r = GK.scale_sweeps(*args, **sweep_kw)
        fl.update(sweeps=sw_r, tm=sweep_kw["tm"])
    lm_r, lv_r = GK.lnl_reduce(*args, **fl)
    pdf_r = GK.lnl_stack(*args, G, lm_r, lv_r, log_thr=log_thr, **fl)
    out = table_route(torch, GK, args, G, flags, log_thr, sweep_kw,
                      None if band is None else band[2])
    sw, lmap, levid, pdf, table = out
    torch.cuda.synchronize()
    if sweep_kw is not None:
        check(torch.equal(sw, sw_r), f"{what}: the table producer's sweep "
                                     "table differs")
    for nm, g, w in (("lmap", lmap, lm_r), ("levid", levid, lv_r),
                     ("pdf", pdf, pdf_r)):
        check(torch.equal(g, w), f"{what}: table route {nm} differs from "
                                 "the recompute route")
    M = args[3].shape[1]
    check(bool(torch.isnan(table[:, M:]).all()),
          f"{what}: the table was written past M")
    if lnl_plain is None:
        lnl_plain = GK.lnl_tile_plain(*args, **fl)
    _, ulp = ulp_err(torch, table[:, :M], lnl_plain)
    check(ulp <= TOL_ULP, f"{what}: the lnl table is {ulp} ulp from "
                          "lnl_tile_plain")
    n_ulp = int((table[:, :M] != lnl_plain).sum())
    return out, {"table_ulp": ulp, "table_ulp_count": n_ulp}, band


def chunk_times(torch, np, GK, args, G, flags, log_thr, sweep_kw=None,
                reps=3, bs=None):
    """The table route's kernels over a batch as the route runs them (row
    chunks of at most TABLE_BYTES_MAX bytes of table, one buffer), each
    kernel's time summed over the chunks (CUDA events), median of `reps`
    after one warm run, which also counts the pairs above the weight
    threshold and the nonzero G entries of their models.  With `bs` (the
    models of `args` in band order) the reader is `lnl_stack_band`.
    Returns ({kernel: ms}, chunks, table bytes of the buffer, kept pairs,
    their nonzero G entries)."""
    B, M = args[0].shape[0], args[3].shape[1]
    rows = GK.table_rows(B, M)
    buf = torch.empty((min(rows, B), GK.table_width(M)),
                      dtype=torch.float32, device=args[0].device)
    stack = "lnl_stack" if bs is None else "lnl_stack_band"
    names = (["scale_sweeps"] if sweep_kw else []) + ["lnl_reduce", stack]
    nnz = ((G if bs is None else bs.G[:M]) != 0).sum(dim=1).to(
        torch.float32)
    runs, kept, kept_nnz = [], 0.0, 0.0
    for rep in range(reps + 1):
        tot = dict.fromkeys(names, 0.0)
        for r0 in range(0, B, rows):
            part = [x[r0:r0 + rows] for x in args[:3]] + list(args[3:])
            table = buf[:part[0].shape[0]]
            fl = dict(flags)
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(names) + 1)]
            ev[0].record()
            if sweep_kw:
                fl.update(tm=sweep_kw["tm"], sweeps=GK.scale_sweeps(
                    *part, table=table, dim_prior=flags.get("dim_prior", True),
                    **sweep_kw))
                ev[1].record()
            lm, lv = GK.lnl_reduce(*part, table=table, **fl)
            ev[-2].record()
            if bs is None:
                GK.lnl_stack(*part, G, lm, lv, log_thr=log_thr, table=table,
                             **fl)
            else:
                GK.lnl_stack_band(table, bs, lm, lv, log_thr=log_thr)
            ev[-1].record()
            ev[-1].synchronize()
            if rep == 0:
                thr = lm + float(np.float32(log_thr))
                keep = (table[:, :M] > thr[:, None]).to(torch.float32)
                kept += float(keep.sum())
                kept_nnz += float((keep @ nnz).sum())
                del keep
            for i, nm in enumerate(names):
                tot[nm] += ev[i].elapsed_time(ev[i + 1])
        runs.append(tot)
    nbytes = buf.numel() * 4
    del buf
    return ({nm: statistics.median(r[nm] for r in runs[1:]) for nm in names},
            -(-B // rows), nbytes, kept, kept_nnz)


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
                        plain_reps=5, bounds=False):
    """Hold the general kernels (with `lnl_onepass`, and `scale_sweeps`
    under free scale with model errors) against their plain versions on
    one case, and the two-pass threshold route on its lnl table against
    the recompute route bit for bit (`table_route_check`); returns
    {kernel: result}, where `lnl_reduce`, `lnl_stack` and `scale_sweeps`
    hold the table route's time as ``ms`` and the recompute route's as
    ``recompute_ms``.  `plain_reps` = 1 times the plain version by the
    call that is compared (free scale with model errors: seconds per
    call).  With `bounds`, each result also holds its bound
    (`general_bounds`)."""
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

    sweep_kw = None
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
        sweep_kw = kw
    lnl_plain = GK.lnl_tile_plain(*args, **flags)

    got, want, ms, pms = run(lambda: GK.lnl_reduce(*args, **flags),
                             lambda: GK.lnl_reduce_plain(*args, **flags))
    reduce_got = got
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

    # The cdf mode's one walk: lmap and the top-T values within TOL_ULP of
    # the plain version, levid TOL_SUM, counts equal, and lmap and levid
    # the lnl_reduce kernel's bit for bit.
    got, want, ms, pms = run(
        lambda: GK.lnl_reduce_topk(*args, T=8, **flags),
        lambda: GK.lnl_reduce_topk_plain(*args, T=8, **flags))
    a0, u0 = ulp_err(torch, got[0], want[0])
    a1, r1 = levid_err(torch, got[1], want[1])
    a2, u2 = ulp_err(torch, got[2], want[2])
    check(u0 <= TOL_ULP, f"{name}: lnl_reduce_topk lmap {u0} ulp from plain")
    check(r1 <= TOL_SUM, f"{name}: lnl_reduce_topk levid err {r1}")
    check(u2 <= TOL_ULP, f"{name}: lnl_reduce_topk values {u2} ulp from "
                         "plain")
    check(torch.equal(got[3], want[3]), f"{name}: lnl_reduce_topk tie counts")
    check(torch.equal(got[0], reduce_got[0])
          and torch.equal(got[1], reduce_got[1]),
          f"{name}: lnl_reduce_topk lmap / levid differ from lnl_reduce's")
    out["lnl_reduce_topk"] = dict(
        max_abs_err=max(a0, a1, a2), lmap_ulp=u0, levid_err=r1, vals_ulp=u2,
        max_ties=float(want[3][:, 0].max()), reduce_bit_equal=True, ms=ms,
        plain_ms=pms)
    if name == "duplicate_models":
        check(float(want[3].max()) >= 2.0, "duplicate models did not tie")
    cut, tie, nkeep, _ = TF.cdf_cut(*want[2:], levid, CDF_THRESH)

    def stack(fn, thr):
        return fn(*args, Gc, lmap, levid, log_thr=thr, **flags)

    # The band stacks read the models in band order.
    bs = GK.band_sort(Gc, *args[3:6])

    def cut_stack(fn, c):
        return fn(*args[:3], bs, c, levid, tie, nkeep, **flags)

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
    got, want, ms, pms = run(
        lambda: GK.lnl_onepass(*args[:3], bs, **flags),
        lambda: GK.lnl_onepass_plain(*args[:3], bs, **flags))
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

    # The two-pass threshold route on the lnl table: bit for bit the
    # recompute route (in band order off free scale with model errors);
    # then each of its kernels timed on the table.
    base = {k: v for k, v in flags.items() if k not in ("sweeps", "tm")}
    (_, lm_t, lv_t, _, table), tab, band = table_route_check(
        torch, np, GK, args, Gc, base, log_thr, name, sweep_kw, lnl_plain)
    reps = 5 if plain_reps > 1 else 3
    targs = args if band is None else band[0]
    timed = {"lnl_reduce": lambda: GK.lnl_reduce(*targs, table=table,
                                                  **flags)}
    if sweep_kw is not None:
        timed["lnl_stack"] = lambda: GK.lnl_stack(
            *args, Gc, lm_t, lv_t, log_thr=log_thr, table=table, **flags)
        timed["scale_sweeps"] = lambda: GK.scale_sweeps(
            *args, table=table, dim_prior=flags.get("dim_prior", True),
            **sweep_kw)
    else:
        # The band reader against its plain version (the flip envelope
        # moves the lnl cut by log(FLIP)); the dense reader `lnl_stack`
        # timed beside it on a caller-order table of the same pairs.
        bs_t = band[2]
        table_c = torch.empty_like(table)
        lm_c, lv_c = GK.lnl_reduce(*args, table=table_c, **flags)
        timed["lnl_stack"] = lambda: GK.lnl_stack(
            *args, Gc, lm_c, lv_c, log_thr=log_thr, table=table_c, **flags)

        def band_stack(fn, thr):
            return fn(table, bs_t, lm_t, lv_t, log_thr=thr)

        got, want, ms, pms = run(
            lambda: band_stack(GK.lnl_stack_band, log_thr),
            lambda: band_stack(GK.lnl_stack_band_plain, log_thr))
        p_row, ok = pdf_rows_close(
            torch, got, want,
            lambda: band_stack(GK.lnl_stack_band_plain,
                               log_thr + np.log(FLIP)),
            lambda: band_stack(GK.lnl_stack_band_plain,
                               log_thr - np.log(FLIP)), TOL_PDF_ROW)
        check(ok, f"{name}: lnl_stack_band PDFs differ beyond the "
                  f"threshold-flip envelope (row-normwise {p_row})")
        out["lnl_stack_band"] = dict(
            max_abs_err=float((got - want).abs().max()), max_rel_err=p_row,
            ms=ms, plain_ms=pms, recompute_ms=median_ms(
                torch, lambda: GK.lnl_stack(*band[0], band[1], lm_t, lv_t,
                                            log_thr=log_thr, **flags),
                reps=reps))
        del got, want
    for kname, fn in timed.items():
        out[kname]["recompute_ms"] = out[kname]["ms"]
        out[kname]["ms"] = median_ms(torch, fn, reps=reps)
    if band is not None:
        out["lnl_stack_band"]["dense_ms"] = out["lnl_stack"]["ms"]
        del table_c, band
    out["lnl_reduce"].update(tab)
    del table
    if bounds:
        sw_mean = (float(flags["sweeps"].float().mean())
                   if flags.get("sweeps") is not None else 0.0)
        for kname, (bms, by) in general_bounds(
                torch, np, GK, TF, args, Gc, flags, (lmap, levid), log_thr,
                cut, tie, nkeep, sw_mean, lnl_plain).items():
            if kname.endswith("_table"):
                # The table route's kernel: its bound is the entry's.
                res = out[kname[:-len("_table")]]
                res.update(recompute_bound_ms=res["bound_ms"],
                           recompute_bound_by=res["bound_by"])
            elif kname.endswith("_dense"):
                out[kname[:-len("_dense")]].update(dense_bound_ms=bms,
                                                   dense_bound_by=by)
                continue
            else:
                res = out[kname]
            res.update(bound_ms=bms, bound_by=by)
    shown = {k: v for k, v in flags.items() if k != "sweeps"}
    sw = out.get("scale_sweeps")
    del lnl_plain, bs
    print(f"kernel_vs_plain {name}: B={d_np.shape[0]} M={m_np.shape[0]} "
          f"F={d_np.shape[1]} {shown} | " + " | ".join(
              f"{k} abs {v['max_abs_err']:.3g} {v['ms']:.3f} ms"
              + (f" (recompute {v['recompute_ms']:.3f} ms)"
                 if "recompute_ms" in v else "")
              + f" (plain {v['plain_ms']:.3f} ms)" for k, v in out.items())
          + f" | lmap {out['lnl_reduce']['lmap_ulp']:.3g} ulp, levid err "
          f"{out['lnl_reduce']['levid_err']:.3g}, top-T "
          f"{out['lnl_reduce_topk']['vals_ulp']:.3g} ulp (lnl_reduce_topk: "
          f"lmap, levid == lnl_reduce's) | table route == "
          f"recompute route bit for bit (sweeps, lmap, levid, pdf), lnl "
          f"table {tab['table_ulp']:.3g} ulp from lnl_tile_plain "
          f"({tab['table_ulp_count']} entries differ)"
          + (f", sweeps mean {sw['mean_sweeps']:.4g} max {sw['max_sweeps']}"
             " (tables equal)" if sw else "")
          + f" | card {card}", flush=True)
    del args
    torch.cuda.empty_cache()
    return out


def band_kernel_check(torch, np, GK, TF, args, G, flags, what):
    """`lnl_onepass` and `lnl_cut_stack` against their plain versions on
    one instantiation, at phase 5's tolerances (lmap 1 ulp, levid
    TOL_SUM, PDFs row-normwise TOL_PDF_ROW, the cut stack inside the
    one-ulp flip envelope of the cut); returns {kernel: ms}."""
    bs = GK.band_sort(G, *args[3:6])
    lmap, levid, vals, cnts = GK.lnl_reduce_topk_plain(*args, T=8, **flags)
    cut, tie, nkeep, _ = TF.cdf_cut(vals, cnts, levid, CDF_THRESH)
    inf = torch.full_like(cut, torch.inf)

    def cut_stack(fn, c):
        return fn(*args[:3], bs, c, levid, tie, nkeep, **flags)

    got = cut_stack(GK.lnl_cut_stack, cut)
    want = cut_stack(GK.lnl_cut_stack_plain, cut)
    p_row, ok = pdf_rows_close(
        torch, got, want,
        lambda: cut_stack(GK.lnl_cut_stack_plain, torch.nextafter(cut, -inf)),
        lambda: cut_stack(GK.lnl_cut_stack_plain, torch.nextafter(cut, inf)),
        TOL_PDF_ROW)
    check(ok, f"{what}: lnl_cut_stack PDFs differ beyond the flip envelope "
              f"(row-normwise {p_row})")
    got = GK.lnl_onepass(*args[:3], bs, **flags)
    want = GK.lnl_onepass_plain(*args[:3], bs, **flags)
    _, u0 = ulp_err(torch, got[1], want[1])
    _, r1 = levid_err(torch, got[2], want[2])
    p1, ok = pdf_rows_close(torch, got[0], want[0], None, None, TOL_PDF_ROW)
    check(u0 <= TOL_ULP and r1 <= TOL_SUM and ok,
          f"{what}: lnl_onepass lmap {u0} ulp, levid {r1}, PDFs {p1}")
    return {"lnl_cut_stack": median_ms(torch, lambda: cut_stack(
        GK.lnl_cut_stack, cut), reps=3),
        "lnl_onepass": median_ms(torch, lambda: GK.lnl_onepass(
            *args[:3], bs, **flags), reps=3),
        "cut_row_err": p_row, "onepass_row_err": p1}


def band_stats(torch, GK, G, margs, card, reps=5):
    """Config 4's G in band order: `band_sort`'s time (CUDA events,
    median of `reps`), each 64-model tile's band (mean and max columns),
    the share of (64-model, 32-column) blocks of G holding a nonzero in
    the caller's order and in band order, and of (64, 128)-column blocks
    in band order (JAX's flags).  `margs`: the (F, M) model arrays the
    sort permutes with G."""
    ms = median_ms(torch, lambda: GK.band_sort(G, *margs), reps=reps)
    M, ngrid = G.shape
    bs = GK.band_sort(G, *margs)
    cols = (bs.bands[:, 1] - bs.bands[:, 0]).to(torch.float64)

    def nonzero_blocks(g, width):
        mp, cp = -(-M // 64) * 64, -(-ngrid // width) * width
        nz = torch.zeros((mp, cp), dtype=torch.bool, device=g.device)
        nz[:M, :ngrid] = g[:M, :ngrid] != 0
        return float(nz.view(mp // 64, 64, cp // width, width)
                     .any(dim=3).any(dim=1).to(torch.float64).mean())

    out = dict(sort_ms=ms, band_cols_mean=float(cols.mean()),
               band_cols_max=int(cols.max()), width=int(bs.width),
               nonzero_blocks_32_caller=nonzero_blocks(G, 32),
               nonzero_blocks_32_band=nonzero_blocks(bs.G, 32),
               nonzero_blocks_128_band=nonzero_blocks(bs.G, 128),
               nnz_per_model=float((G != 0).sum(dim=1).to(
                   torch.float64).mean()))
    lib = GK._build.load()
    ldg = bs.G.shape[1]
    out["blocks_per_sm"] = {k: lib.fz_lnl_band_blocks(NFILT, ldg, bs.width, c)
                            for k, c in (("onepass", 0), ("cut_stack", 1))}
    out["smem_bytes"] = lib.fz_lnl_band_smem(NFILT, ldg, bs.width, 0)
    print(f"band_sort: config 4's G ({M} x {ngrid}), {out['nnz_per_model']:.4g}"
          f" nonzero columns a model: sort {ms:.3f} ms (median of {reps}); "
          f"band columns a 64-model tile mean {out['band_cols_mean']:.4g} max "
          f"{out['band_cols_max']}, widest rounded to 4 {out['width']}; "
          f"nonzero (64-model, 32-column) blocks caller order "
          f"{out['nonzero_blocks_32_caller']:.4f}, band order "
          f"{out['nonzero_blocks_32_band']:.4f}; (64, 128) blocks band order "
          f"{out['nonzero_blocks_128_band']:.4f}; band kernels "
          f"{out['smem_bytes']} B shared a block, blocks an SM "
          f"{out['blocks_per_sm']} | card {card}", flush=True)
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


def som_phase(torch, np, KS, tens, card):
    """Config 3's SOM half (bench.py:164-215, without the GNG) on the
    card; returns the `som_train` entry of the kernels line and the
    model set and fit objects, which phase 9 reuses."""
    from frankenz_tpu_torch.kernels import build as kbuild
    from frankenz_tpu_torch.kernels import probe as PRB
    from frankenz_tpu_torch.kernels import som as SK
    from frankenz_tpu_torch.models import SelfOrganizingMap
    from frankenz_tpu_torch.models import networks as TN
    from frankenz_tpu_torch.ops import summarize as TS

    f32 = np.float32
    rng3 = np.random.default_rng(0)
    m3 = rng3.uniform(1, 10, (N3, NFILT)).astype(f32)
    me3 = (0.05 * m3).astype(f32)
    z3 = rng3.uniform(0, 3, N3)
    zerr3 = np.full(N3, 0.05)
    grid3 = np.linspace(0, 3.2, NGRID3)
    ones3 = np.ones_like(m3)
    train_kw = dict(nside=NSIDE3, nproj=2, nbatch=NBATCH3, seed=1,
                    verbose=False)
    som = SelfOrganizingMap(m3, me3, ones3, device="cuda")
    som.train_network(niter=2, **train_kw)  # warm-up: allocator, library
    torch.cuda.synchronize()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    som.train_network(niter=NITER3, **train_kw)
    train_s = time.perf_counter() - t0
    launches = KS.launch_counts()
    T, N = NITER3 * NBATCH3, NSIDE3 ** 2
    idx = torch.cuda.current_device()
    K_s = SK.choose_cluster({k: SK._active(idx, N, NFILT, 2, k)
                             for k in SK.CLUSTER_SIZES})
    check(K_s > 1 and launches["som_train_cluster"] == 1
          and launches["som_train"] == 0,
          f"config 3 train_network did not launch som_train once on its "
          f"cluster route (K={K_s}; {launches})")
    check(som.nodes.shape == (N, NFILT)
          and np.isfinite(som.nodes).all(), "config 3 SOM nodes")

    # The kernel's inputs as train_network makes them (the same draws).
    kw = dict(nside=NSIDE3, wt_thresh=1e-3,
              lr=SK.schedule("harmonic", 0.5, 0.1),
              nb=SK.schedule("harmonic", 0.7, 0.02))

    def inputs(niter):
        rng = np.random.default_rng(1)
        init = m3[rng.choice(N3, size=NSIDE3 ** 2, replace=False)]
        draws = rng.integers(0, N3, size=niter * NBATCH3)
        return [tens(a) for a in (init, som.nodes_pos.astype(f32))
                + TN.som_kernel_draws(m3, me3, ones3, draws)]

    # 10,000 steps at full width (niter 200): kernel against plain.
    t_chk = inputs(NITER3_CHECK)
    got, bmu_k = SK.som_train(*t_chk, return_bmu=True, **kw)
    want, bmu_p = SK.som_train_plain(*t_chk, return_bmu=True, **kw)
    torch.cuda.synchronize()
    check(torch.equal(bmu_k, bmu_p), "som_train best nodes differ from the "
          "plain version over the 10,000-step run")
    err10 = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    check(err10 <= TOL_SOM_NODES, f"som_train nodes differ from the plain "
          f"version over 10,000 steps (rel {err10})")
    abs10 = float((got - want).abs().max())
    del t_chk, got, want

    # The whole 100,000-step run: the kernel on its cluster route (the
    # default) and on one block (cluster=1), bit-equal, both timed; then
    # the plain version.
    t_full = inputs(NITER3)
    kmap, bmu_kf = SK.som_train(*t_full, return_bmu=True, **kw)
    torch.cuda.synchronize()
    check(np.array_equal(kmap.cpu().numpy().astype(float), som.nodes),
          "som_train on train_network's inputs differs from its map")
    bmap, bmu_bf = SK.som_train(*t_full, return_bmu=True, cluster=1, **kw)
    check(torch.equal(bmu_kf, bmu_bf)
          and torch.equal(kmap.view(torch.int32), bmap.view(torch.int32)),
          f"som_train's cluster route (K={K_s}) differs from its block route "
          f"over the whole {T}-step run")
    del bmap, bmu_bf
    ms = median_ms(torch, lambda: SK.som_train(*t_full, **kw), reps=3)
    block_ms = median_ms(torch, lambda: SK.som_train(*t_full, cluster=1,
                                                     **kw), reps=3)
    threads_s = SK.cluster_threads(N, K_s)
    smem_s = kbuild.load().fz_som_train_cluster_smem(N, NFILT, 2, K_s)
    # The step's floor on the cluster: one cluster barrier and one DSMEM
    # load at K (kernels.probe).
    prb = PRB.cluster_probe(torch.device("cuda"), sizes=(K_s,),
                            iters=40_000)[K_s]
    floor_us = 1e-3 * (prb["barrier_ns"] + prb["dsmem_load_ns"])
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    pmap, bmu_pf = SK.som_train_plain(*t_full, return_bmu=True, **kw)
    e1.record()
    e1.synchronize()
    plain_ms = e0.elapsed_time(e1)
    same_steps = int((bmu_kf == bmu_pf).sum())
    abs100 = float((kmap - pmap).abs().max())
    # Operations per (step, node): the score 5F + 4 (inter, shape, the
    # divide, the log and its tail), the neighbourhood 3P + 3, the
    # update 3F; bytes: the nodes and positions once, the three (T, F)
    # draw arrays, the trained nodes.
    b_ms, b_by = bound(float(T) * N * (8 * NFILT + 3 * 2 + 11),
                       4.0 * (2 * N * NFILT + 2 * N + 3 * T * NFILT))
    print(f"som_train: config 3, {N} nodes x {NFILT} filters, {T} steps: "
          f"kernel on a cluster of {K_s} CTAs ({threads_s} threads, {smem_s} "
          f"bytes of shared memory a CTA, the launch asking at least "
          f"122,880) {ms:.3f} ms ({1e3 * ms / T:.4f} us/step), on one block "
          f"{block_ms:.3f} ms ({1e3 * block_ms / T:.4f} us/step), "
          f"bit-equal over the whole run (nodes and every best node); "
          f"floor a step {floor_us:.4f} us (one cluster barrier "
          f"{prb['barrier_ns']:.1f} ns + one DSMEM load "
          f"{prb['dsmem_load_ns']:.1f} ns at K={K_s}); plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); 10,000-step "
          f"run: best nodes equal, nodes max rel {err10:.3g}; 100,000-step "
          f"run: {same_steps} of {T} best nodes equal, nodes max abs "
          f"{abs100:.3g} | card {card}", flush=True)

    # Both maps populated: the mean best-node lmap of the 100,000 models.
    t0 = time.perf_counter()
    som.populate_network(verbose=False)
    pop_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    som.populate_network(verbose=False)
    pop_s = time.perf_counter() - t0
    plain_som = SelfOrganizingMap(m3, me3, ones3, device="cuda")
    plain_som.nodes = pmap.cpu().numpy().astype(float)
    plain_som.nodes_pos = som.nodes_pos
    plain_som.populate_network(verbose=False)
    del t_full, kmap, pmap
    lm_k, lm_p = (float(np.mean(x.models_lmap)) for x in (som, plain_som))
    check(np.isfinite(lm_k) and np.isfinite(lm_p)
          and abs(lm_k - lm_p) <= TOL_SOM_LMAP * abs(lm_p),
          f"mean best-node lmap: kernel map {lm_k}, plain map {lm_p}")
    check(int(som.nodes_Nbmu.sum()) == N3, "populate: BMU counts")
    print(f"config 3 populate_network: {N3} models x {N} nodes: cold "
          f"{pop_cold:.4f} s, warm {pop_s:.4f} s; occupied nodes "
          f"{int((som.nodes_Nmatch > 0).sum())}, largest membership "
          f"{int(som.nodes_Nmatch.max())}; mean best-node lmap: kernel map "
          f"{lm_k:.6f}, plain map {lm_p:.6f} | card {card}", flush=True)

    # Nodes-only fit_predict over 10,000 objects, 2,048 per batch.
    d3 = (m3[rng3.integers(0, N3, N3_FIT)]
          + rng3.normal(0, 0.3, (N3_FIT, NFILT))).astype(f32)
    fit = (d3, np.full_like(d3, 0.3), np.ones_like(d3), z3, zerr3)
    fkw = dict(label_grid=grid3, nodes_only=True, verbose=False,
               batch_size=BATCH3, save_fits=False, return_gof=True)
    t0 = time.perf_counter()
    pdfs, gof = som.fit_predict(*fit, **fkw)
    cold = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        pdfs, gof = som.fit_predict(*fit, **fkw)
        walls.append(time.perf_counter() - t0)
    fit_s = statistics.median(walls)
    check(pdfs.shape == (N3_FIT, NGRID3) and np.isfinite(pdfs).all()
          and np.isfinite(gof[0]).all() and np.isfinite(gof[1]).all(),
          "config 3 nodes-only fit_predict output")
    check(np.all(np.abs(pdfs.sum(axis=1) - 1.0) <= 1e-4),
          "config 3 nodes-only PDF rows do not sum to 1")
    check(np.all(gof[0] <= gof[1] + 1e-6 * (1.0 + np.abs(gof[0]))),
          "config 3 nodes-only lmap > levid")
    sub = tuple(x[:BATCH3] for x in fit[:3]) + fit[3:]
    ref = som.fit_predict(*sub, **dict(fkw, save_fits=True))
    check(np.allclose(pdfs[:BATCH3], ref[0], rtol=1e-5, atol=1e-7)
          and np.allclose(gof[0][:BATCH3], ref[1][0], rtol=1e-5)
          and np.allclose(gof[1][:BATCH3], ref[1][1], rtol=1e-5),
          "config 3 nodes-only fit_predict differs from fit + predict")
    print(f"config 3 nodes-only fit_predict: {N3_FIT} objects x "
          f"{int((som.nodes_Nmatch > 0).sum())} nodes x {NGRID3} grid, batch "
          f"{BATCH3}: cold {cold:.4f} s, warm median {fit_s:.4f} s "
          f"({N3_FIT / fit_s:.6g} objects/s, repeats "
          f"{', '.join(f'{w:.4f}' for w in walls)}); {BATCH3} rows equal "
          f"fit + predict | card {card}", flush=True)

    # The exact-union route over 2,048 objects: the streamed batches
    # against fit + predict, with max_neighbors the widest union.
    occ = np.flatnonzero(som.nodes_Nmatch > 0)
    nodes_occ = tens(som.nodes[occ].astype(f32))
    members = torch.tensor(som.nodes_idxs[occ].astype(np.int64),
                           device="cuda")
    width = 24 * som.nodes_idxs.shape[1]
    nu_max = 0
    for i0 in range(0, N3_UNION, 256):
        x = [tens(a[i0:i0 + 256]) for a in fit[:3]]
        _, nuniq = TN._gather_union(*x, nodes_occ, members,
                                    lpnet_spec=som._lpnet_spec(),
                                    wt_thresh=1e-3, cdf_thresh=2e-4,
                                    cap_sel=24, max_neighbors=width)
        nu_max = max(nu_max, int(nuniq.max()))
    del members, nodes_occ
    ukw = dict(label_grid=grid3, nodes_only=False, verbose=False,
               batch_size=256, return_gof=True,
               max_neighbors=-(-nu_max // 128) * 128)
    usub = tuple(x[:N3_UNION] for x in fit[:3]) + fit[3:]
    t0 = time.perf_counter()
    got = som.fit_predict(*usub, save_fits=False, **ukw)
    union_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = som.fit_predict(*usub, save_fits=True, **ukw)
    union_ref_s = time.perf_counter() - t0
    check(np.isfinite(got[0]).all() and np.isfinite(got[1][1]).all(),
          "config 3 exact-union fit_predict output")
    check(np.allclose(got[0], ref[0], rtol=2e-3, atol=2e-5)
          and np.allclose(got[1][0], ref[1][0], rtol=1e-5)
          and np.allclose(got[1][1], ref[1][1], rtol=1e-5),
          "config 3 exact-union fit_predict differs from fit + predict")
    print(f"config 3 exact-union fit_predict: {N3_UNION} objects, widest "
          f"union {nu_max} models (max_neighbors {ukw['max_neighbors']}), "
          f"batch 256: streamed {union_s:.4f} s, fit + predict "
          f"{union_ref_s:.4f} s, equal within rtol 2e-3 | card {card}",
          flush=True)

    t0 = time.perf_counter()
    summ, gof_s = som.fit_summarize(*fit, label_grid=grid3, nodes_only=True,
                                    batch_size=BATCH3, verbose=False)
    summ_s = time.perf_counter() - t0
    cols = np.stack([np.asarray(c) for est in summ[:4] for c in est]
                    + [np.asarray(c) for c in summ[4:]], axis=1)
    want = TS.pdfs_summarize(torch.tensor(pdfs, device="cuda"), grid3,
                             u=np.random.default_rng(0).random(N3_FIT))
    check(np.isclose(cols, TS._pack_summary(want).cpu().numpy(), rtol=2e-5,
                     atol=2e-6, equal_nan=True).all(),
          "config 3 fit_summarize differs from pdfs_summarize(fit_predict)")
    check(np.array_equal(gof_s[0], gof[0]), "config 3 fit_summarize lmap")
    print(f"config 3 nodes-only fit_summarize: wall {summ_s:.4f} s "
          f"({N3_FIT / summ_s:.6g} objects/s), 21 columns match "
          f"pdfs_summarize(fit_predict) | card {card}", flush=True)
    print(f"config 3 SOM summary: train {train_s:.4f} s, populate "
          f"{pop_s:.4f} s, nodes-only fit_predict {N3_FIT / fit_s:.6g} "
          f"objects/s | card {card}", flush=True)
    torch.cuda.empty_cache()
    entry = {"name": "som_train", "route": "cuda",
             "source": "frankenz_tpu_torch/csrc/som_train.cu",
             "replaces": "frankenz_tpu/models/networks.py:1280",
             "launches": launches["som_train"] + launches[
                 "som_train_cluster"],
             "launches_by_route": {k: launches[k] for k in (
                 "som_train", "som_train_cluster")},
             "max_abs_err": max(abs10, abs100), "ms": ms, "cluster": K_s,
             "us_per_step": 1e3 * ms / T, "block_ms": block_ms,
             "block_us_per_step": 1e3 * block_ms / T,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             # No PyTorch call trains a SOM.
             "library_ms": None, "train_s": train_s, "populate_s": pop_s,
             "fit_objects_per_s": N3_FIT / fit_s,
             "steps_equal_100k": same_steps}
    # The cluster route on its own (`som_train_cluster_kernel`, the route
    # train_network takes): its launches on the main path, its CTA and the
    # step's floor beside the time.
    cluster_entry = dict(entry, name="som_train_cluster",
                         launches=launches["som_train_cluster"],
                         threads_per_cta=threads_s, smem_per_cta=smem_s,
                         floor_us_per_step=floor_us,
                         probe_barrier_ns=prb["barrier_ns"],
                         probe_dsmem_load_ns=prb["dsmem_load_ns"])
    del cluster_entry["launches_by_route"]
    return [entry, cluster_entry], (m3, me3, ones3, fit, grid3)


def gng_phase(torch, np, KS, tens, card, m3, me3, ones3, fit, grid3):
    """Config 3's GNG half (bench.py:164-172, :201-209) on the card, over
    phase 8's model set and objects; returns the `gng_train` entry of the
    kernels line."""
    from frankenz_tpu_torch.kernels import gng as GG
    from frankenz_tpu_torch.models import GrowingNeuralGas
    from frankenz_tpu_torch.models import networks as TN

    T, N = NITER_G * NBATCH3, NMAX_G
    train_kw = dict(niter=NITER_G, nbatch=NBATCH3, max_nodes=N, seed=SEED_G,
                    verbose=False)
    gng = GrowingNeuralGas(m3, me3, ones3, device="cuda")
    t0 = time.perf_counter()
    gng.train_network(**train_kw)
    cold_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    gng.train_network(**train_kw)
    train_s = time.perf_counter() - t0
    launches = KS.launch_counts()
    idx = torch.cuda.current_device()
    K_g = GG.choose_cluster({k: GG._active(idx, N, NFILT, k)
                             for k in GG.CLUSTER_SIZES})
    route = "gng_train_cluster" if K_g > 1 else "gng_train"
    check(K_g > 1 and launches[route] == 1 and sum(launches.values()) == 1,
          f"config 3 GNG train_network did not launch gng_train once on "
          f"its cluster route (K={K_g}; {launches})")
    nedge = len(gng.edges())
    check(1 < gng.NNODE <= N and np.isfinite(gng.nodes).all()
          and np.isfinite(gng.nodes_err).all() and nedge > 0,
          "config 3 GNG nodes")

    # The kernel's inputs as train_network makes them (the same draws).
    rng = np.random.default_rng(SEED_G)
    draws = rng.integers(0, N3, size=T)
    i1, i2 = rng.choice(N3, size=2, replace=False)
    pos0 = np.zeros((N, NFILT), np.float32)
    pos0[0], pos0[1] = m3[i1], m3[i2]
    alive0 = np.zeros(N, bool)
    alive0[:2] = True
    ids0 = np.full((N, GG.K), -1, np.int32)
    ids0[0, 0], ids0[1, 0] = 1, 0
    start = [tens(a) for a in (pos0, np.zeros(N, np.float32), alive0, ids0,
                               np.zeros((N, GG.K), np.int32),
                               np.zeros(N, np.int32))] + [0]
    xc, iv, xr = (tens(a) for a in TN.som_kernel_draws(m3, me3, ones3,
                                                        draws))
    kw = dict(nbatch=NBATCH3)

    def run(fn, state, s0, s1, **route):
        return fn(*state, xc[s0:s1], iv[s0:s1], xr[s0:s1], **kw, **route)

    def equal(a, b):
        return (all(torch.equal(x, y) for x, y in zip(a[:6], b[:6]))
                and a[6] == b[6])

    full = run(GG.gng_train, start, 0, T)
    torch.cuda.synchronize()
    alive = full[2].cpu().numpy()
    check(np.array_equal(full[0].cpu().numpy()[alive].astype(float),
                         gng.nodes), "gng_train on train_network's inputs "
          "differs from its graph")
    ms = median_ms(torch, lambda: run(GG.gng_train, start, 0, T), reps=3)
    # The whole run on the block route (cluster=1), bit-equal to the
    # cluster route's, timed beside it.
    block = run(GG.gng_train, start, 0, T, cluster=1)
    check(equal(block, full), f"gng_train's cluster route (K={K_g}) differs "
          f"from its block route over the whole {T}-step run")
    block_ms = median_ms(torch, lambda: run(GG.gng_train, start, 0, T,
                                            cluster=1), reps=3)
    del block

    # Kernel against plain, bit for bit on every state array: the first
    # PREFIX_G steps (the graph grows, the prune fires), TAIL_G steps from
    # the kernel's own state at step MID_G (a full graph), a hub whose
    # full slots drop edges (the column search).
    k_pre = run(GG.gng_train, start, 0, PREFIX_G)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    p_pre = run(GG.gng_train_plain, start, 0, PREFIX_G)
    e1.record()
    e1.synchronize()
    plain_ms = e0.elapsed_time(e1)
    check(equal(k_pre, p_pre), f"gng_train differs from its plain version "
          f"over the first {PREFIX_G} steps")
    mid = run(GG.gng_train, start, 0, MID_G)
    k_tail = run(GG.gng_train, mid, MID_G, MID_G + TAIL_G)
    p_tail = run(GG.gng_train_plain, mid, MID_G, MID_G + TAIL_G)
    check(equal(k_tail, p_tail), f"gng_train differs from its plain version "
          f"over {TAIL_G} steps from step {MID_G}")
    hub_k, hub_p = gng_hub_case(torch, np, GG, TN, tens)
    check(hub_k[6] > 0 and equal(hub_k, hub_p), "gng_train differs from its "
          "plain version on the overflow hub")
    # Segments compose: MID_G steps, then the rest from that state.
    check(equal(run(GG.gng_train, mid, MID_G, T), full),
          "a run cut at step MID_G differs from the run in one launch")
    # Alive nodes along the run (SEGS_G equal segments, which must compose
    # too), for the bound: the work is the score of every alive node.
    state, counts = start, [2]
    for k in range(SEGS_G):
        state = run(GG.gng_train, state, k * T // SEGS_G,
                    (k + 1) * T // SEGS_G)
        counts.append(int(state[2].sum()))
    check(equal(state, full), f"{SEGS_G} segments differ from one launch")
    mean_alive = float(np.mean([(a + b) / 2 for a, b in zip(counts,
                                                            counts[1:])]))
    # Operations per (step, alive node): the score 5F + 4 and its top-2
    # compare; bytes: the three (T, F) draw arrays, the state in and out.
    b_ms, b_by = bound(float(T) * mean_alive * (5 * NFILT + 5),
                       4.0 * (3 * T * NFILT + 2 * N * (NFILT + 3 + 2 * GG.K)))
    deg = 2.0 * nedge / gng.NNODE
    print(f"gng_train: config 3, {N} nodes x {NFILT} filters, {T} steps: "
          f"kernel on a cluster of {K_g} CTAs {ms:.3f} ms "
          f"({1e3 * ms / T:.4f} us/step), on one block {block_ms:.3f} ms "
          f"({1e3 * block_ms / T:.4f} us/step), bit-equal; plain "
          f"{plain_ms:.3f} ms for the first {PREFIX_G} steps "
          f"({plain_ms / PREFIX_G * 1e3:.4f} us/step), bound {b_ms:.4f} ms "
          f"({b_by}; mean alive nodes {mean_alive:.1f}, alive at the "
          f"segment ends {counts}); bit-equal to plain over the first "
          f"{PREFIX_G} steps, {TAIL_G} steps from step {MID_G} and the hub "
          f"(overflow {hub_k[6]}); segments compose | card {card}",
          flush=True)
    print(f"config 3 GNG train_network: cold {cold_s:.4f} s, warm "
          f"{train_s:.4f} s; {gng.NNODE} nodes, {nedge} edges, mean degree "
          f"{deg:.4f}, edge_overflow {gng.edge_overflow} | card {card}",
          flush=True)
    del full, k_pre, p_pre, mid, k_tail, p_tail, state, xc, iv, xr

    # The network fitter on the trained GNG.
    t0 = time.perf_counter()
    gng.populate_network(verbose=False)
    pop_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    gng.populate_network(verbose=False)
    pop_s = time.perf_counter() - t0
    check(int(gng.nodes_Nbmu.sum()) == N3, "GNG populate: BMU counts")
    fkw = dict(label_grid=grid3, nodes_only=True, verbose=False,
               batch_size=BATCH3, save_fits=False, return_gof=True)
    t0 = time.perf_counter()
    pdfs, gof = gng.fit_predict(*fit, **fkw)
    cold = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        pdfs, gof = gng.fit_predict(*fit, **fkw)
        walls.append(time.perf_counter() - t0)
    fit_s = statistics.median(walls)
    check(pdfs.shape == (N3_FIT, NGRID3) and np.isfinite(pdfs).all()
          and np.isfinite(gof[0]).all() and np.isfinite(gof[1]).all()
          and np.all(np.abs(pdfs.sum(axis=1) - 1.0) <= 1e-4),
          "config 3 GNG nodes-only fit_predict output")
    sub = tuple(x[:BATCH3] for x in fit[:3]) + fit[3:]
    ref = gng.fit_predict(*sub, **dict(fkw, save_fits=True))
    check(np.allclose(pdfs[:BATCH3], ref[0], rtol=1e-5, atol=1e-7)
          and np.allclose(gof[0][:BATCH3], ref[1][0], rtol=1e-5)
          and np.allclose(gof[1][:BATCH3], ref[1][1], rtol=1e-5),
          "config 3 GNG nodes-only fit_predict differs from fit + predict")
    print(f"config 3 GNG populate_network: {N3} models x {gng.NNODE} nodes: "
          f"cold {pop_cold:.4f} s, warm {pop_s:.4f} s; occupied nodes "
          f"{int((gng.nodes_Nmatch > 0).sum())}, largest membership "
          f"{int(gng.nodes_Nmatch.max())} | card {card}", flush=True)
    print(f"config 3 GNG nodes-only fit_predict: {N3_FIT} objects, batch "
          f"{BATCH3}: cold {cold:.4f} s, warm median {fit_s:.4f} s "
          f"({N3_FIT / fit_s:.6g} objects/s, repeats "
          f"{', '.join(f'{w:.4f}' for w in walls)}); {BATCH3} rows equal "
          f"fit + predict | card {card}", flush=True)
    torch.cuda.empty_cache()
    return {"name": "gng_train", "route": "cuda",
            "source": "frankenz_tpu_torch/csrc/gng_train.cu",
            "replaces": "frankenz_tpu/models/networks.py:2017",
            "launches": launches["gng_train"] + launches[
                "gng_train_cluster"],
            "launches_by_route": {k: launches[k] for k in (
                "gng_train", "gng_train_cluster")},
            # Every comparison above is bit for bit.
            "max_abs_err": 0.0, "ms": ms, "cluster": K_g,
            "us_per_step": 1e3 * ms / T, "block_ms": block_ms,
            "block_us_per_step": 1e3 * block_ms / T,
            "plain_ms": plain_ms, "plain_steps": PREFIX_G,
            "bound_ms": b_ms, "bound_by": b_by,
            # No PyTorch call trains a GNG.
            "library_ms": None, "train_s": train_s, "populate_s": pop_s,
            "fit_objects_per_s": N3_FIT / fit_s, "nodes": gng.NNODE,
            "edges": nedge, "edge_overflow": gng.edge_overflow}


def gng_hub_case(torch, np, GG, TN, tens):
    """A node holding 32 edges beside a twin it is not joined to, on four
    5-band blobs, 100 steps with max_age 1000: the upserts to the hub
    drop, the adjacency turns one-sided and the kernel takes the column
    search.  Returns the kernel's and the plain version's states."""
    rng = np.random.default_rng(5)
    centers = rng.uniform(2, 9, (4, NFILT))
    m = np.vstack([c + rng.normal(0, 0.3, (60, NFILT)) for c in centers])
    leaves = centers[1:][rng.integers(0, 3, 32)] + rng.normal(
        0, 0.5, (32, NFILT))
    graph = {"pos": np.vstack([centers[0], centers[0] * 1.001, leaves,
                               centers[3] + 0.1]),
             "edges": [(0, 2 + k, 0) for k in range(32)] + [(1, 34, 0)]}
    state = [tens(a) for a in TN._gng_seed_state(graph, 40, NFILT)] + [0]
    draws = [tens(a) for a in TN.som_kernel_draws(
        m, np.full_like(m, 0.05), np.ones_like(m),
        rng.integers(0, len(m), 100))]
    kw = dict(nbatch=25, max_age=1000)
    return (GG.gng_train(*state, *draws, **kw),
            GG.gng_train_plain(*state, *draws, **kw))


def smooth_nz(np, nz, sig=2.0):
    """Gaussian-smooth a binned N(z): the deconvolution is identified only
    up to the kernel scale (tests/test_samplers.py:68-74)."""
    grid = np.arange(nz.shape[-1])
    K = np.exp(-0.5 * ((grid[None, :] - grid[:, None]) / sig) ** 2)
    K /= K.sum(axis=1, keepdims=True)
    return nz @ K


def check_chain(np, what, samples, lnps, pdfs, nz, check_lnp=True):
    """Finite, on the simplex, the final lnpost that of the final sample
    (float64), and the smoothed posterior mean over the second half nearer
    to the truth than the smoothed stack; returns the two distances."""
    check(np.isfinite(samples).all() and np.isfinite(lnps).all(),
          f"{what}: non-finite chain")
    check(np.all(np.abs(samples.sum(axis=1) - 1.0) <= 1e-3)
          and (samples >= 0).all(), f"{what}: samples off the simplex")
    if check_lnp:
        want = np.sum(np.log(pdfs @ samples[-1]))
        check(abs(lnps[-1] - want) <= 1e-3 * abs(want),
              f"{what}: final lnpost {lnps[-1]} against {want} in float64")
    stack = pdfs.sum(axis=0) / pdfs.sum()
    post = samples[len(samples) // 2:].mean(axis=0)
    err_post = float(np.abs(smooth_nz(np, post) - smooth_nz(np, nz)).sum())
    err_stack = float(np.abs(smooth_nz(np, stack) - smooth_nz(np, nz)).sum())
    check(err_post < err_stack, f"{what}: posterior mean ({err_post}) no "
          f"nearer to the true N(z) than the stack ({err_stack})")
    return err_post, err_stack


def first_differing_step(torch, PK, draws, pdfsT, carry, mh):
    """The first Gibbs step at which kernel and plain version differ on
    this segment (both rerun with thin 1), or None."""
    k = PK.pop_chain(draws, pdfsT, *carry, thin=1, mh_steps=mh)
    p = PK.pop_chain_plain(draws, pdfsT, *carry, thin=1, mh_steps=mh)
    diff = ((k[0] != p[0]).any(dim=2) | (k[1] != p[1])).any(dim=0)
    return int(diff.nonzero()[0]) if bool(diff.any()) else None


def zero_overlap_case(torch, np, tens):
    """12 bins x 300 objects, 400 steps: no mass in the last 4 bins (pairs
    touching them have scale 0 and a NaN gradient), 5 objects with PDFs in
    those bins only (overlap 0, on the 1e-30 floor), normals of 4 sigma
    (many moves to a negative bin, scored -3.0e38).  Returns the inputs."""
    rng = np.random.default_rng(41)
    nbins, nobs, T, mh = 12, 300, 400, 3
    c = rng.uniform(0, nbins - 1, (nobs, 1))
    pdfs = np.exp(-0.5 * ((np.arange(nbins)[None] - c) / 1.5) ** 2) + 0.01
    pdfs[:5, :nbins - 4] = 0.0
    pdfs[5:, nbins - 4:] = 0.0
    pdfs /= pdfs.sum(axis=1, keepdims=True)
    pos = rng.dirichlet(np.full(nbins, 5.0), 1)
    pos[:, nbins - 4:] = 0.0
    pos /= pos.sum(axis=1, keepdims=True)
    i = rng.integers(0, nbins, (1, T))
    j = rng.integers(0, nbins - 1, (1, T))
    j = j + (j >= i)
    draws = np.concatenate([i[..., None], j[..., None],
                            4.0 * rng.normal(size=(1, T, mh)),
                            rng.exponential(size=(1, T, mh))], axis=2)
    return (tens(draws.astype(np.float32)),
            tens(pdfs.T.astype(np.float32)), tens(pos.astype(np.float32)))


def sampler_phase(torch, np, KS, tens, card):
    """Config 5 (bench.py:218-254) on the card: the population sampler on
    the `pop_chain` kernel, its general route, and the hierarchical
    sampler; returns the `pop_chain` entry of the kernels line."""
    from frankenz_tpu_torch.kernels import pop as PK
    from frankenz_tpu_torch.samplers import (hierarchical_sampler,
                                             population_sampler)
    from frankenz_tpu_torch.samplers import population as TP

    rng = np.random.default_rng(0)
    grid = np.arange(NBINS5)
    nz = np.exp(-0.5 * ((grid - 18) / 5.0) ** 2)
    nz /= nz.sum()
    zt = rng.choice(NBINS5, NOBS5, p=nz)
    c = zt + rng.normal(0, 1.5, NOBS5)
    pdfs = np.exp(-0.5 * ((grid[None] - c[:, None]) / 1.5) ** 2)
    pdfs /= pdfs.sum(1, keepdims=True)
    T = NITER_P * THIN_P
    run_kw = dict(thin=THIN_P, mh_steps=MH_P, seed=SEED_P, verbose=False)

    # Walls: cold, then warm with the counters reset just before.
    ps = population_sampler(pdfs, device="cuda")
    t0 = time.perf_counter()
    ps.run_mcmc(NITER_P, **run_kw)
    cold_s = time.perf_counter() - t0
    ps.reset()
    torch.cuda.synchronize()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    ps.run_mcmc(NITER_P, **run_kw)
    pop_s = time.perf_counter() - t0
    launches = KS.launch_counts()
    idx = torch.cuda.current_device()
    width = 2 + 2 * MH_P
    K_p = PK.choose_cluster(
        1, torch.cuda.get_device_properties(idx).multi_processor_count,
        {k: PK._active(idx, NOBS5, width, MH_P, k)
         for k in PK.cluster_sizes(NOBS5, width)})
    check(K_p > 1 and launches["pop_chain_cluster"] == 1
          and sum(launches.values()) == 1,
          f"config 5 population run_mcmc did not launch pop_chain once on "
          f"its cluster route (K={K_p}; {launches})")
    samples, lnps = ps.results
    check(samples.shape == (NITER_P, NBINS5) and lnps.shape == (NITER_P,),
          "config 5 population results' shape")
    err_post, err_stack = check_chain(np, "config 5 population", samples,
                                      lnps, pdfs, nz)

    # The kernel's inputs as run_mcmc makes them (the same table).
    draws = ps._tables(SEED_P, 1, T, NBINS5, MH_P).contiguous()
    pdfsT = ps._pdfsT()
    stack0 = np.tile(pdfs.sum(axis=0) / pdfs.sum(), (1, 1))
    start = ps._start(stack0, TP._zero_prior, True)
    kw = dict(thin=THIN_P, mh_steps=MH_P)

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def joined(a, b):
        return (torch.cat([a[0], b[0]], dim=1),
                torch.cat([a[1], b[1]], dim=1)) + tuple(b[2:5])

    full = PK.pop_chain(draws, pdfsT, *start, **kw)
    torch.cuda.synchronize()
    check(np.array_equal(full[0][0].cpu().numpy().astype(float), samples)
          and np.array_equal(full[1][0].cpu().numpy().astype(float), lnps),
          "pop_chain on run_mcmc's inputs differs from its chain")
    # Gibbs steps in which at least one proposal was accepted (the kernel
    # reports no count of its own): the position or lnpost changed, from a
    # rerun with thin 1.
    every = PK.pop_chain(draws, pdfsT, *start, thin=1, mh_steps=MH_P)
    check(equal(every[2:], full[2:]), "thin 1 changes pop_chain's carry")
    pos_steps = torch.cat([start[0], every[0][0]])
    lnp_steps = torch.cat([start[2], every[1][0]])
    moved = int(((pos_steps[1:] != pos_steps[:-1]).any(dim=1)
                 | (lnp_steps[1:] != lnp_steps[:-1])).sum())
    del every, pos_steps, lnp_steps
    ms = median_ms(torch, lambda: PK.pop_chain(draws, pdfsT, *start, **kw),
                   reps=3)
    # The whole chain on the block route (cluster=1), bit-equal to the
    # cluster route's, timed beside it.
    block = PK.pop_chain(draws, pdfsT, *start, cluster=1, **kw)
    check(equal(block, full), f"pop_chain's cluster route (K={K_p}) differs "
          f"from its block route over the whole {T}-step chain")
    block_ms = median_ms(torch, lambda: PK.pop_chain(
        draws, pdfsT, *start, cluster=1, **kw), reps=3)
    del block

    # Kernel against plain, bit for bit on samples, lnpost and the carry.
    def seg(fn, carry, s0, s1):
        return fn(draws[:, s0:s1].contiguous(), pdfsT, *carry, **kw)

    def differs(what, carry, s0, s1):
        step = first_differing_step(
            torch, PK, draws[:, s0:s1].contiguous(), pdfsT, carry, MH_P)
        fail(f"pop_chain differs from its plain version over {what}, first "
             f"at Gibbs step {s0 + (step or 0)}")

    k_pre = seg(PK.pop_chain, start, 0, PREFIX_P)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    p_pre = seg(PK.pop_chain_plain, start, 0, PREFIX_P)
    e1.record()
    e1.synchronize()
    plain_ms, plain_steps = e0.elapsed_time(e1), PREFIX_P
    if not equal(k_pre, p_pre):
        differs(f"the first {PREFIX_P} steps", start, 0, PREFIX_P)
    if plain_ms * T / PREFIX_P <= 1e3 * PLAIN_BUDGET_P:
        e0.record()
        p_rest = seg(PK.pop_chain_plain, p_pre[2:], PREFIX_P, T)
        e1.record()
        e1.synchronize()
        plain_ms, plain_steps = plain_ms + e0.elapsed_time(e1), T
        if not equal(joined(p_pre, p_rest), full):
            differs("the whole chain", p_pre[2:], PREFIX_P, T)
        plain_note = f"the whole {T}-step chain"
    else:
        mid = seg(PK.pop_chain, start, 0, MID_P)
        k_tail = seg(PK.pop_chain, mid[2:], MID_P, MID_P + TAIL_P)
        p_tail = seg(PK.pop_chain_plain, mid[2:], MID_P, MID_P + TAIL_P)
        if not equal(k_tail, p_tail):
            differs(f"{TAIL_P} steps from step {MID_P}", mid[2:], MID_P,
                    MID_P + TAIL_P)
        plain_note = (f"the first {PREFIX_P} steps and {TAIL_P} steps from "
                      f"the kernel's carry at step {MID_P}")
    # Segments compose, resident or not; the non-resident variant, forced
    # at this shape, equals the resident one over the whole chain.
    check(equal(joined(k_pre, seg(PK.pop_chain, k_pre[2:], PREFIX_P, T)),
                full), f"a chain cut at step {PREFIX_P} differs from one "
          "launch")
    e0.record()
    nonres = PK.pop_chain(draws, pdfsT, *start, resident=False, **kw)
    e1.record()
    e1.synchronize()
    nonres_ms = e0.elapsed_time(e1)
    check(equal(nonres, full), "the non-resident pop_chain differs from the "
          "resident one")
    # Zero overlaps and moves to negative bins.
    zd, zpT, zpos = zero_overlap_case(torch, np, tens)
    zov = (zpos @ zpT).contiguous()
    zlnp = PK.tree_sum(torch.log(zov.clamp_min(1e-30)),
                       PK.chain_threads(zov.shape[1]))
    zk = PK.pop_chain(zd, zpT, zpos, zov, zlnp, thin=10, mh_steps=3)
    zp = PK.pop_chain_plain(zd, zpT, zpos, zov, zlnp, thin=10, mh_steps=3)
    check(equal(zk, zp) and bool(torch.isfinite(zk[1]).all())
          and bool((zk[3][:, :5] == 0).all())
          and not torch.equal(zk[2], zpos),
          "pop_chain differs from its plain version on the zero-overlap "
          "case")

    # Four chains in one launch: chain c equals a single-chain launch on
    # chain c's table.
    ps4 = population_sampler(pdfs, device="cuda")
    KS.reset_launch_counts()
    ps4.run_mcmc(NITER_P4, nchains=NCHAINS_P, **run_kw)
    check(sum(KS.launch_counts().values()) == 1,
          f"{NCHAINS_P} chains took {KS.launch_counts()} launches")
    s4, l4 = ps4.results_by_chain
    d4 = ps4._tables(SEED_P, NCHAINS_P, NITER_P4 * THIN_P, NBINS5, MH_P)
    for ch in range(NCHAINS_P):
        one = PK.pop_chain(d4[ch:ch + 1].contiguous(), pdfsT, *start, **kw)
        check(np.array_equal(one[0][0].cpu().numpy().astype(float),
                             s4[:, ch])
              and np.array_equal(one[1][0].cpu().numpy().astype(float),
                                 l4[:, ch]),
              f"chain {ch} of {NCHAINS_P} differs from its own launch")
    check(not np.array_equal(s4[:, 0], s4[:, 1]), "chains 0 and 1 are equal")

    # Segments through the entry point: sample(block=7) streams the stored
    # chain bit for bit, and draws the table once.
    ndraws = []
    orig_draws = TP._pop_draws

    def counting_draws(gen, nsteps, nbins, mh_steps):
        ndraws.append(nsteps)
        return orig_draws(gen, nsteps, nbins, mh_steps)

    TP._pop_draws = counting_draws
    try:
        streamer = population_sampler(pdfs, device="cuda")
        KS.reset_launch_counts()
        t0 = time.perf_counter()
        got = list(streamer.sample(NITER_P, block=BLOCK_P, **run_kw))
        stream_s = time.perf_counter() - t0
    finally:
        TP._pop_draws = orig_draws
    nblocks = -(-NITER_P // BLOCK_P)
    check(ndraws == [T] and sum(KS.launch_counts().values()) == nblocks,
          f"sample(block={BLOCK_P}): tables drawn {ndraws}, launches "
          f"{KS.launch_counts()}")
    check(len(got) == NITER_P and all(
        np.array_equal(p, samples[i]) and lp == lnps[i]
        for i, (p, lp) in enumerate(got)),
        f"sample(block={BLOCK_P}) differs from the stored run_mcmc chain")

    # The carried overlap against pdfs . pos in float64.
    ov64 = pdfs @ full[2][0].cpu().numpy().astype(float)
    ov_k = full[3][0].cpu().numpy().astype(float)
    drift = float(np.max(np.abs(ov_k - ov64) / ov64))
    lnp_off = float(lnps[-1] - np.sum(np.log(ov64)))
    check(float(ov_k.min()) > 1e-25, "an overlap reached the floor")

    # Bound: per Gibbs step ~16 operations an object in the gradient pass
    # (dcol, half, the ratio, the series or a log) and 5 per proposal
    # (the update's multiply and add, the floor, the log, the sum), 2 more
    # per accepted proposal, of which this run had at least one in every
    # step that moved; bytes: each input read once (pdfsT, the table, the
    # carry) and each output written once (the samples, the carry).
    b_ms, b_by = bound(
        float(T) * NOBS5 * (16 + 5 * MH_P) + 2.0 * moved * NOBS5,
        4.0 * (pdfsT.numel() + draws.numel() + 2 * (NOBS5 + NBINS5 + 1)
               + NITER_P * (NBINS5 + 1)))
    print(f"pop_chain: config 5, {NBINS5} bins x {NOBS5} objects, {T} Gibbs "
          f"steps x {MH_P} proposals: kernel on a cluster of {K_p} CTAs "
          f"{ms:.3f} ms ({1e3 * ms / T:.4f} us/step), on one block "
          f"{block_ms:.3f} ms ({1e3 * block_ms / T:.4f} us/step), "
          f"bit-equal; non-resident {nonres_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms for {plain_steps} steps "
          f"({plain_ms / plain_steps * 1e3:.4f} us/step), bound {b_ms:.4f} "
          f"ms ({b_by}); bit-equal to plain over {plain_note}, on the "
          f"zero-overlap case, cut at step {PREFIX_P}, non-resident, and "
          f"{NCHAINS_P} chains in one launch | card {card}", flush=True)
    print(f"config 5 population run_mcmc: cold {cold_s:.4f} s, warm "
          f"{pop_s:.4f} s = {T * MH_P / pop_s:.6g} proposals/s; {moved} of {T} "
          f"Gibbs steps ({moved / T:.4f}) accepted at least one of their "
          f"{MH_P} proposals; "
          f"sample(block={BLOCK_P}) {stream_s:.4f} s in {nblocks} launches, "
          f"equal to run_mcmc; final lnpost {lnps[-1]:.3f}; smoothed "
          f"posterior-mean error {err_post:.5f} against the stack's "
          f"{err_stack:.5f}; overlap drift max |ov - pdfs.pos| / ov "
          f"{drift:.3e} after {T} Gibbs steps, final lnpost "
          f"{lnp_off:+.4f} from sum log(pdfs.pos) in float64 | card {card}",
          flush=True)

    # The general route: under a Dirichlet(2) prior, then under the flat
    # prior on the kernel route's table.  Float32 lnpost has a spacing of
    # ~0.004 at -5e4, the two routes sum in different orders, and the
    # chain amplifies rounding differences, so sooner or later the chains
    # part: they are held together up to that step, and by their lnpost
    # after it.
    def dirichlet2(pos):
        return torch.log(pos).sum()

    pg = population_sampler(pdfs, device="cuda")
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    pg.run_mcmc(NITER_PG, logprior_nz=dirichlet2, **run_kw)
    gen_s = time.perf_counter() - t0
    check(sum(KS.launch_counts().values()) == 0,
          "the general route launched a kernel")
    gs, gl = pg.results
    check(np.isfinite(gs).all() and np.isfinite(gl).all()
          and np.all(np.abs(gs.sum(axis=1) - 1.0) <= 1e-3)
          and (gs >= 0).all(), "general route under a prior: chain")
    Tg = NITER_PG * THIN_P
    dg = ps._tables(SEED_P, 1, T, NBINS5, MH_P)[:, :Tg].contiguous()
    # The step loop itself on the card, every one of these steps, under the
    # prior: in float64, SEG64_P steps at a time from the carry of the same
    # loop on CPU tensors, held to it at 1e-6 on samples, lnpost and the
    # carry.  (The chain amplifies rounding differences, through the step
    # scale 1 / |grad| of a cancelling sum, by some 5% a step: from a
    # common carry SEG64_P steps stay far inside 1e-6, 2,000 would not.)
    s_cpu, s_card = (population_sampler(pdfs, device=dev, dtype=torch.float64)
                     for dev in ("cpu", "cuda"))
    d64 = dg.to("cpu", torch.float64)
    carry = s_cpu._start(stack0, dirichlet2, False)
    for a, b in zip(s_card._start(stack0, dirichlet2, False), carry):
        check(bool(torch.isclose(a.cpu(), b, rtol=1e-12, atol=0).all()),
              "the float64 start on the card differs from the CPU's")
    gkw = dict(prior=dirichlet2, thin=1, mh_steps=MH_P)
    moved64, err64 = 0, 0.0
    for s0 in range(0, Tg, SEG64_P):
        seg = d64[:, s0:s0 + SEG64_P].contiguous()
        want = TP._pop_run(seg, s_cpu._pdfsT(), *carry, **gkw)
        got = TP._pop_run(seg.cuda(), s_card._pdfsT(),
                          *(x.cuda() for x in carry), **gkw)
        for name, g, w in zip(("samples", "lnpost", "pos", "overlap", "lnp"),
                              got, want):
            g = g.cpu()
            check(bool(torch.isfinite(g).all())
                  and bool(torch.isclose(g, w, rtol=1e-6, atol=1e-12).all()),
                  f"general route in float64 under a prior, card against "
                  f"CPU tensors, steps {s0} to {s0 + SEG64_P}: {name} "
                  f"differ by {float((g - w).abs().max())}")
        err64 = max(err64, float(((got[1].cpu() - want[1]).abs()
                                  / want[1].abs()).max()))
        lnp_steps = torch.cat([carry[2], want[1][0]])
        moved64 += int((lnp_steps[1:] != lnp_steps[:-1]).sum())
        carry = want[2:]
    check(moved64 >= Tg // 4, f"the float64 chain moved in {moved64} of {Tg} "
          "steps")
    flat = TP._pop_run(dg, pdfsT, *ps._start(stack0, TP._zero_prior, False),
                       prior=TP._zero_prior, thin=1, mh_steps=MH_P)
    kern = PK.pop_chain(dg, pdfsT, *start, thin=1, mh_steps=MH_P)
    close = (torch.isclose(flat[0][0], kern[0][0], rtol=2e-4,
                           atol=2e-6).all(dim=1)
             & torch.isclose(flat[1][0], kern[1][0], rtol=2e-5, atol=2e-4))
    parted = int((~close).nonzero()[0]) if not bool(close.all()) else Tg
    lnp_f, lnp_k = float(flat[4][0]), float(kern[4][0])
    check(parted >= 10, f"the general route parts from the kernel route at "
          f"Gibbs step {parted}")
    check(abs(lnp_f - lnp_k) <= 1e-3 * abs(lnp_k)
          and bool(torch.isfinite(flat[0]).all())
          and float(flat[3].min()) > 1e-25,
          f"general route under the flat prior: lnpost {lnp_f} against the "
          f"kernel route's {lnp_k}")
    print(f"general route: {NITER_PG} x {THIN_P} steps under a Dirichlet(2) "
          f"prior {gen_s:.4f} s ({1e3 * gen_s / Tg:.4f} ms/step), final "
          f"lnpost {gl[-1]:.3f}; under the flat prior on the kernel route's "
          f"table it matches it (rtol 2e-4) for the first {parted} of {Tg} "
          f"Gibbs steps, lnpost after {Tg} steps {lnp_f:.3f} against "
          f"{lnp_k:.3f}; in float64 under the prior the card follows the "
          f"same loop on CPU tensors over all {Tg} steps ({moved64} moved), "
          f"{SEG64_P} at a time from the CPU's carry, samples, lnpost and "
          f"carry within rtol 1e-6 (lnpost max rel {err64:.3e}) | card "
          f"{card}", flush=True)
    del full, nonres, k_pre, p_pre, flat, kern

    # The hierarchical sampler.
    hs = hierarchical_sampler(pdfs, device="cuda")
    hkw = dict(thin=THIN_H, seed=SEED_P, verbose=False)
    t0 = time.perf_counter()
    hs.run_mcmc(NITER_H, **hkw)
    hcold_s = time.perf_counter() - t0
    hs.reset()
    torch.cuda.synchronize()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    hs.run_mcmc(NITER_H, **hkw)
    hier_s = time.perf_counter() - t0
    check(sum(KS.launch_counts().values()) == 0,
          "the hierarchical sampler launched a kernel")
    hsam, hlnp = hs.results
    check(hsam.shape == (NITER_H, NBINS5), "config 5 hierarchical results")
    herr, _ = check_chain(np, "config 5 hierarchical", hsam, hlnp, pdfs, nz,
                          check_lnp=False)
    ref = np.random.default_rng(1).multinomial(2_000, nz).astype(float)
    hr = hierarchical_sampler(pdfs, device="cuda")
    t0 = time.perf_counter()
    hr.run_mcmc(20, ref_sample=ref, **hkw)
    href_s = time.perf_counter() - t0
    check_chain(np, "config 5 hierarchical with a reference sample",
                *hr.results, pdfs, nz, check_lnp=False)
    sweeps = NITER_H * THIN_H
    print(f"config 5 hierarchical run_mcmc: {NITER_H} x thin {THIN_H}: cold "
          f"{hcold_s:.4f} s, warm {hier_s:.4f} s = {sweeps / hier_s:.6g} "
          f"sweeps/s, {sweeps * NOBS5 / hier_s:.6g} object-draws/s; smoothed "
          f"posterior-mean error {herr:.5f} against the stack's "
          f"{err_stack:.5f}; 20 x thin {THIN_H} with a 2,000-object "
          f"reference sample {href_s:.4f} s | card {card}", flush=True)
    torch.cuda.empty_cache()
    return {"name": "pop_chain", "route": "cuda",
            "source": "frankenz_tpu_torch/csrc/pop_chain.cu",
            "replaces": "frankenz_tpu/samplers/population.py:179",
            "launches": launches["pop_chain"] + launches[
                "pop_chain_cluster"],
            "launches_by_route": {k: launches[k] for k in (
                "pop_chain", "pop_chain_cluster")},
            # Every comparison above is bit for bit.
            "max_abs_err": 0.0, "ms": ms, "cluster": K_p,
            "us_per_step": 1e3 * ms / T, "block_ms": block_ms,
            "block_us_per_step": 1e3 * block_ms / T,
            "nonresident_ms": nonres_ms,
            "plain_ms": plain_ms, "plain_steps": plain_steps,
            "bound_ms": b_ms, "bound_by": b_by,
            # No PyTorch call runs an MH chain.
            "library_ms": None, "population_s": pop_s,
            "proposals_per_s": T * MH_P / pop_s, "steps_moved": moved,
            "overlap_drift": drift, "lnpost_off": lnp_off,
            "general_parted_at_step": parted,
            "hierarchical_s": hier_s,
            "hierarchical_sweeps_per_s": sweeps / hier_s,
            "hierarchical_obj_draws_per_s": sweeps * NOBS5 / hier_s}


def expf_underflow(torch, np, SC, SCK, card):
    """Where the card's expf flushes to 0: every float32 x in [-110,
    -100] through the screened kernels' own expf (`expf_probe`, same
    file and flags), torch.exp on the card (the plain versions there)
    and on CPU tensors.  Each must be monotone (every zero below every
    nonzero) and flush everything at or below `LN_W_UNDERFLOW`, the
    premise of the exact underflow cut.  Returns {label: (largest x
    giving 0, smallest x giving nonzero)}."""
    lo = np.float32(-110.0).view(np.int32)
    hi = np.float32(-100.0).view(np.int32)
    xs = np.arange(hi, lo + 1, dtype=np.int64).astype(np.int32).view(
        np.float32)
    out = {}
    for label, fn, dev in (("kernel expf", SCK.expf_probe, "cuda"),
                           ("torch.exp cuda", torch.exp, "cuda"),
                           ("torch.exp cpu", torch.exp, "cpu")):
        y = fn(torch.from_numpy(xs.copy()).to(dev)).cpu().numpy()
        zero = y == 0.0
        out[label] = (float(xs[zero].max()), float(xs[~zero].min()))
        check(out[label][0] < out[label][1],
              f"{label} is not monotone past its underflow")
        check(out[label][1] > SC.LN_W_UNDERFLOW,
              f"{label} is nonzero at {out[label][1]} <= the underflow cut "
              f"{SC.LN_W_UNDERFLOW}: the cut is not exact")
    print("expf underflow over every float32 in [-110, -100]: " + ", ".join(
        f"{k}: largest x -> 0.0 {v[0]!r}, smallest x -> nonzero {v[1]!r}"
        for k, v in out.items())
        + f"; cut at ln w <= {SC.LN_W_UNDERFLOW} is exact | card {card}",
        flush=True)
    return out


def screened_bounds(torch, FM, srt, gates, stats, tm, wthr):
    """({kept weights per row, models kept by some row per 32-row
    block}, {kernel: (bound ms, bound by)}) of the screened trio on one
    sorted batch, the bounds from the work that this run's gates admit: K1's operations per
    pair (chi^2 6 per filter + 2 compares, or + ~10 for the weight chain)
    over the admitted pairs (the run fractions `stats`: pass A's, pass
    B's weight work), pass B's 2 Ngrid per kept weight (counted from the
    plain weights, 2,048 rows at a time), the seed's pairs over each
    block's home tile.  Bytes: every input once (the (S, B) bounds, the
    visit table and the per-row cuts included), every output once."""
    B, F = srt.d.shape
    M, ngrid = srt.mT.shape[1], srt.G.shape[1]
    a1 = 0.5 * F - 1.0
    S, nb = srt.bmin.shape
    pairs = float(B) * M
    kept = kept_models = 0.0
    for r0 in range(0, B, N_KERNEL):
        sl = slice(r0, r0 + N_KERNEL)
        w = FM._weights_plain(FM._chi2_plain(
            srt.d[sl], srt.de[sl], srt.mT, srt.meT, False),
            gates.shift[sl, None], a1) > wthr
        kept += float(w.sum())
        # Models that some row of a 32-row block keeps (the blocks are
        # whole: N_KERNEL is a multiple of 32).
        n = w.shape[0] // srt.tb * srt.tb
        kept_models += float(w[:n].reshape(-1, srt.tb, M).any(dim=1).sum())
        del w
    io = 4.0 * (2 * B * F + 2 * F * M)
    kept_stats = {"kept_per_row": kept / B,
                  "kept_models_per_block": kept_models / (B // srt.tb)}
    return kept_stats, {
        "screen_seed": bound(float(B) * tm * (6 * F + 2),
                             4.0 * (2 * B * F + 2 * F * min(nb * tm, M)
                                    + nb + B)),
        "chi2_brackets_screened": bound(pairs * stats[0] * (6 * F + 2),
                                        io + 4.0 * (S * B + B + 2 * B)),
        "chi2_stack_screened": bound(
            pairs * stats[1] * (6 * F + 10) + 2.0 * ngrid * kept,
            io + 4.0 * (M * ngrid + S * B + nb * S + 5 * B + B * ngrid
                        + B))}


def screened_phase(torch, np, tens, card, cases, batch_case):
    """Phase 3b, the screened trio (K2) at config 4's widths: the expf
    underflow; each kernel against its plain version on phase 3's cases
    (config 4 at B=2,048, ragged M=99,937 with B=1,000, F=20, an
    all-clamped row) at the route's own sizes (512-model subtiles and
    home tiles, 32-object blocks), the brackets also against the K1
    pair's; then the route: screened == run-all and absorption on == off
    bit for bit, lmap == the K1 route's bit for bit, levid and PDFs
    within the end-to-end tolerances, under wt_thresh 1e-3 and None, on
    one 65,536-object batch and the edge cases.  Returns ({kernel: {case:
    result}}, expf thresholds, {case: run fractions})."""
    from frankenz_tpu_torch.kernels import fullmask as FM
    from frankenz_tpu_torch.kernels import screened as SCK
    from frankenz_tpu_torch.ops import fused as TF
    from frankenz_tpu_torch.ops import screen as SC

    expf = expf_underflow(torch, np, SC, SCK, card)
    f32 = np.float32
    wthr = float(np.exp(np.log(WT_THRESH)))
    results = {k: {} for k in ("screen_seed", "chi2_brackets_screened",
                               "chi2_stack_screened")}
    for name, d_np, m_np, Gc in cases:
        B, F = d_np.shape
        M, ngrid = m_np.shape[0], Gc.shape[1]
        a1 = 0.5 * F - 1.0
        c0 = 2.0 * a1
        tm = TF.group_width(M, 512)
        sm = 512 if tm % 512 == 0 else tm
        srt = SC.sort_and_bound(
            tens(d_np), tens(np.full(d_np.shape, 0.25, f32)), tens(m_np.T),
            tens((0.05 * m_np).astype(f32).T), Gc, sm=sm, tm=tm, tb=SCK.TB,
            ignore_model_err=False)
        args = (srt.d, srt.de, srt.mT, srt.meT)

        def seed_k():
            return SCK.screen_seed(*args, srt.start, width=tm, c0=c0)

        def seed_p():
            return SCK.screen_seed_plain(*args, srt.start, width=tm, c0=c0)

        sk, sp = seed_k(), seed_p()
        torch.cuda.synchronize()
        sd_abs, sd_rel = rel_err(torch, sk, sp)
        check(sd_rel <= TOL_BRACKET,
              f"{name}: screen_seed differs from plain (rel {sd_rel})")
        seed = torch.minimum(srt.seed, sp)

        def brackets_k():
            return SCK.chi2_brackets_screened(*args, srt.bounds, seed, c0=c0,
                                              sm=sm)

        def brackets_p():
            return SCK.chi2_brackets_screened_plain(*args, srt.bounds, seed,
                                                    c0=c0, sm=sm)

        bk, bp = brackets_k(), brackets_p()
        torch.cuda.synchronize()
        errs = [rel_err(torch, g, w) for g, w in zip(bk, bp)]
        b_abs, b_rel = max(e[0] for e in errs), max(e[1] for e in errs)
        check(b_rel <= TOL_BRACKET, f"{name}: chi2_brackets_screened "
                                    f"differs from plain (rel {b_rel})")
        pair = FM.chi2_brackets_plain(*args, c0=c0)
        check(all(torch.equal(g, w) for g, w in zip(bp, pair)),
              f"{name}: the screened brackets are not the K1 pair's")
        gates = SC.stack_gates(srt, *bp, wt_thresh=WT_THRESH)
        stats = [float(x) for x in SC.run_fractions(srt, seed, gates)]

        def stack(fn, thr=wthr):
            return fn(*args, srt.G, gates.shift, srt.bounds, gates.visit,
                      gates.cut_uf, gates.cut_dot, gates.ph, gates.cut_abs,
                      a1=a1, sm=sm, wthr=thr)

        (pk, s_k), (pp, s_p) = (stack(SCK.chi2_stack_screened),
                                stack(SCK.chi2_stack_screened_plain))
        torch.cuda.synchronize()
        s_abs, s_rel = rel_err(torch, s_k, s_p)
        check(s_rel <= TOL_SUM, f"{name}: chi2_stack_screened weight sums "
                                f"differ (rel {s_rel})")
        p_row, ok = pdf_rows_close(
            torch, pk, pp,
            lambda: stack(SCK.chi2_stack_screened_plain, wthr * FLIP)[0],
            lambda: stack(SCK.chi2_stack_screened_plain, wthr / FLIP)[0],
            TOL_PDF_ROW)
        check(ok, f"{name}: chi2_stack_screened PDFs differ beyond the "
                  f"threshold-flip envelope (row-normwise {p_row})")
        p_abs = float((pk - pp).abs().max())
        t = {"screen_seed": (median_ms(torch, seed_k),
                             median_ms(torch, seed_p)),
             "chi2_brackets_screened": (median_ms(torch, brackets_k),
                                        median_ms(torch, brackets_p)),
             "chi2_stack_screened": (
                 median_ms(torch, lambda: stack(SCK.chi2_stack_screened)),
                 median_ms(torch,
                           lambda: stack(SCK.chi2_stack_screened_plain)))}
        for kname, ab, rl in (("screen_seed", sd_abs, sd_rel),
                              ("chi2_brackets_screened", b_abs, b_rel),
                              ("chi2_stack_screened", max(p_abs, s_abs),
                               max(p_row, s_rel))):
            results[kname][name] = dict(
                max_abs_err=ab, max_rel_err=rl, ms=t[kname][0],
                plain_ms=t[kname][1], run_fractions=stats)
        if name == "config4":
            kept_stats, bds = screened_bounds(torch, FM, srt, gates, stats,
                                              tm, wthr)
            for kname, bd in bds.items():
                results[kname][name].update(zip(("bound_ms", "bound_by"),
                                                bd))
            results["chi2_stack_screened"][name].update(kept_stats)
            print(f"kept weights at B={B}: {kept_stats['kept_per_row']:.3f} "
                  f"per row, {kept_stats['kept_models_per_block']:.1f} "
                  f"models kept by some row per 32-row block", flush=True)
        print(f"kernel_vs_plain screened {name}: B={B} M={M} F={F} "
              f"Ngrid={ngrid} sm={sm} | " + " | ".join(
                  f"{k} abs {results[k][name]['max_abs_err']:.3g} rel "
                  f"{results[k][name]['max_rel_err']:.3g} {t[k][0]:.3f} ms "
                  f"(plain {t[k][1]:.3f} ms)" for k in t)
              + f" | run fractions A {stats[0]:.4f} B {stats[1]:.4f} dot "
              f"{stats[2]:.4f} | card {card}", flush=True)
        del srt, args, bk, bp, pk, pp, sk, sp, gates, pair
        torch.cuda.empty_cache()

    # The route through `fused_fit_pdf`, against its run-all twin, with
    # absorption off, and against the K1 route.
    fractions = {}
    for name, d_np, m_np, Gc in [batch_case] + list(cases[1:]):
        ones_d = np.ones_like(d_np)
        t_in = [tens(d_np), tens(np.full(d_np.shape, 0.25, f32)),
                tens(ones_d), tens(m_np), tens((0.05 * m_np).astype(f32)),
                tens(np.ones_like(m_np)), Gc]
        for wt in (WT_THRESH, None):
            scr = TF.fused_fit_pdf(*t_in, wt_thresh=wt, screen_stats=True)
            twins = {"run-all": TF.fused_fit_pdf(*t_in, wt_thresh=wt,
                                                 screen_run_all=True),
                     "absorption off": TF.fused_fit_pdf(
                         *t_in, wt_thresh=wt, screen_absorb=False)}
            for twin, out in twins.items():
                for a, b, nm in zip(scr[:3], out, ("pdf", "lmap", "levid")):
                    check(torch.equal(a, b), f"{name}, wt_thresh {wt}: "
                                             f"screened {nm} != {twin}")
            k1 = TF.fused_fit_pdf(*t_in, wt_thresh=wt, screen=False)
            check(torch.equal(scr[1], k1[1]),
                  f"{name}, wt_thresh {wt}: screened lmap != the K1 route's")
            fin = torch.isfinite(k1[2])
            check(torch.equal(fin, torch.isfinite(scr[2])),
                  f"{name}: non-finite levid differ from the K1 route's")
            lv = float(((scr[2][fin] - k1[2][fin]).abs()
                        / (2e-5 + 2e-5 * k1[2][fin].abs())).max())
            check(lv <= 1.0, f"{name}, wt_thresh {wt}: levid off the K1 "
                             f"route's ({lv} x tol)")
            close = torch.isclose(scr[0], k1[0], rtol=2e-3, atol=2e-5)
            check(bool(close.all()), f"{name}, wt_thresh {wt}: PDFs off the "
                                     "K1 route's beyond rtol 2e-3 / atol "
                                     "2e-5")
            fractions[f"{name} wt_thresh={wt}"] = [float(x) for x in scr[3]]
            print(f"screened route {name}, wt_thresh {wt}: B={d_np.shape[0]}"
                  f" == run-all and == absorption off bit for bit; lmap == "
                  f"K1's bit for bit, levid {lv:.3g} x tol of K1's; run "
                  f"fractions A {fractions[f'{name} wt_thresh={wt}'][0]:.4f}"
                  f" B {fractions[f'{name} wt_thresh={wt}'][1]:.4f} dot "
                  f"{fractions[f'{name} wt_thresh={wt}'][2]:.4f} | card "
                  f"{card}", flush=True)
            del scr, twins, k1
        del t_in
        torch.cuda.empty_cache()
    return results, expf, fractions


def neighbor_check(np, what, got, want, ties, cands):
    """Neighbour lists `got` against `want` (host (B, J) arrays): equal
    row for row, except rows that `knn._near_ties` flags (`ties` (B,),
    `cands` (B, M), host bools), where only models of near-equal pairs
    may differ or swap.  Fewer than 1% of the rows may need that.
    Returns the rows that differ."""
    diff = np.nonzero((got != want).any(axis=1))[0]
    for b in diff:
        check(ties[b], f"{what}: row {b}'s neighbours differ without a "
                       "near tie")
        a, w = set(got[b][got[b] >= 0]), set(want[b][want[b] >= 0])
        check(all(cands[b][m] for m in a ^ w),
              f"{what}: row {b}'s neighbours differ outside its near ties")
    check(len(diff) < 0.01 * len(got),
          f"{what}: {len(diff)} of {len(got)} rows differ by near ties")
    return diff


def knn_phase(torch, np, card):
    """Phase 11: config 2 (bench.py:112-160) at full width on the port:
    the mock catalog, the NearestNeighbors fitter and its calls, each
    held against the port on the CPU; returns nothing (no kernel of its
    own: the search, union, posterior and KDE are torch)."""
    from frankenz_tpu_torch.models import NearestNeighbors
    from frankenz_tpu_torch.models import knn as TKNN
    from frankenz_tpu_torch.ops import summarize as TS
    from frankenz_tpu_torch.sim import MockSurvey, make_sdss_mock

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    cat = make_sdss_mock(nobj=N2_MOCK, seed=13, cache=False)
    torch.cuda.synchronize()
    cat_s = time.perf_counter() - t0
    ncat = len(cat["phot"])
    check(ncat >= N2_TRAIN + N2_TEST, f"config 2 mock has {ncat} objects")
    check(all(np.isfinite(cat[k]).all() for k in ("phot", "phot_err",
                                                   "redshifts")),
          "config 2 mock: non-finite columns")
    # The synthesis on the card against the port on the CPU, float64.
    zs = cat["redshifts"][:N2_SYNTH].astype(float)
    ts = cat["templates"][:N2_SYNTH]
    got = MockSurvey("sdss", "cww+", "bpz").synthesize_objects(zs, ts)
    want = MockSurvey("sdss", "cww+", "bpz",
                      device="cpu").synthesize_objects(zs, ts)
    synth_err = float(np.max(np.abs(got - want)
                             / np.maximum(np.abs(want), 1e-300)))
    check(synth_err <= 1e-10, f"config 2 synthesis on the card differs "
                              f"from the CPU ({synth_err} relative)")
    print(f"config 2 mock: make_sdss_mock({N2_MOCK}, seed=13) {ncat} "
          f"objects in {cat_s:.4f} s; synthesize_objects of {N2_SYNTH} "
          f"pairs on the card vs the CPU: max relative error "
          f"{synth_err:.3g} (tol 1e-10) | card {card}", flush=True)

    sl_m = slice(0, N2_TRAIN)
    sl_d = slice(N2_TRAIN, N2_TRAIN + N2_TEST)
    m, me, mmask = (cat[k][sl_m] for k in ("phot", "phot_err", "phot_mask"))
    z = cat["redshifts"][sl_m]
    zerr = 0.02 * (1.0 + z)
    d, de, dmask = (cat[k][sl_d] for k in ("phot", "phot_err", "phot_mask"))
    ztrue = cat["redshifts"][sl_d]
    grid = np.linspace(0, 7.0, N2_GRID)

    t0 = time.perf_counter()
    nn = NearestNeighbors(m, me, mmask, K=N2_K, seed=1, verbose=False)
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    nn_cpu = NearestNeighbors(m, me, mmask, K=N2_K, seed=1, verbose=False,
                              device="cpu")
    f_abs, f_rel = rel_err(torch, nn.features.cpu(), nn_cpu.features)
    check(f_rel <= 1e-6, f"config 2 features differ from the CPU's "
                         f"({f_rel} relative)")
    print(f"config 2 NearestNeighbors(K={N2_K}, seed=1) over {N2_TRAIN} "
          f"models: {ctor_s:.4f} s; features vs the CPU: max abs "
          f"{f_abs:.3g}, max relative {f_rel:.3g} (tol 1e-6) | card {card}",
          flush=True)

    kw = dict(label_grid=grid, k=N2_KNN, verbose=False, return_gof=True)
    nn.fit_predict(d[:4096], de[:4096], dmask[:4096], z, zerr, **kw)
    walls, outs = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(nn.fit_predict(d, de, dmask, z, zerr,
                                   rng=np.random.default_rng(7), **kw))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    pdfs, (lmap, levid) = outs[0]
    check(pdfs.shape == (N2_TEST, N2_GRID) and np.isfinite(pdfs).all()
          and np.isfinite(lmap).all() and np.isfinite(levid).all(),
          "config 2 fit_predict: shape or non-finite values")
    check(np.allclose(pdfs.sum(axis=1), 1.0, atol=1e-4),
          "config 2 fit_predict: PDFs are not normalized")
    check(all(np.array_equal(o[0], pdfs) and np.array_equal(o[1][0], lmap)
              and np.array_equal(o[1][1], levid) for o in outs[1:]),
          "config 2 fit_predict: repeated calls differ")
    wall = statistics.median(walls)
    approx = nn.fit_predict(d, de, dmask, z, zerr, approx=True,
                            rng=np.random.default_rng(7), **kw)
    check(np.array_equal(approx[0], pdfs)
          and np.array_equal(approx[1][0], lmap)
          and np.array_equal(approx[1][1], levid),
          "config 2 fit_predict(approx=True) differs from the exact search")
    zhat = grid[np.argmax(pdfs, axis=1)]
    dz = (zhat - ztrue) / (1 + ztrue)
    nmad = float(1.48 * np.median(np.abs(dz - np.median(dz))))
    outl = float(np.mean(np.abs(dz) > 0.15))
    print(f"config 2 fit_predict: {N2_TEST} objects x {N2_TRAIN} models, "
          f"K={N2_K}, k={N2_KNN}, {N2_GRID}-point grid: walls "
          + ", ".join(f"{w:.4f}" for w in walls)
          + f" s, median {wall:.4f} s ({N2_TEST / wall:.6g} objects/s); "
          f"sigma_NMAD {nmad:.6g}, outlier fraction {outl:.6g}; "
          f"approx=True bit-equal | card {card}", flush=True)

    # 512 of those objects against the port on the CPU, the same draws
    # (the first batch's first rows).  The expanded distance cancels
    # (|q|^2 ~ 300 against neighbour gaps of ~1e-4 here), so inputs that
    # differ in an ulp move near-equal distances: the CPU fitter is held
    # on every row with the card's inputs, its ensembles (as
    # `utils.knn_from_jax` carries JAX's) and its query features.  Each
    # device's own inputs are compared as a printed statistic only.
    n = N2_CHECK
    sub = (d[:n], de[:n], dmask[:n], z, zerr)
    fkw = dict(kw, save_fits=True)
    got = nn.fit_predict(*sub, rng=np.random.default_rng(7), **fkw)
    own = {}
    nn_cpu.fit_predict(*sub, rng=np.random.default_rng(7), **fkw)
    own["own ensembles and query features"] = nn_cpu.neighbors
    nn_cpu.features = nn.features.cpu()
    nn_cpu.features_sqnorm = nn.features_sqnorm.cpu()
    nn_cpu.fit_predict(*sub, rng=np.random.default_rng(7), **fkw)
    own["the card's ensembles, own query features"] = nn_cpu.neighbors
    jq = np.random.default_rng(7).normal(np.asarray(d[:n], float),
                                         np.abs(np.asarray(de[:n], float)))
    q = nn._query_features(jq, de[:n])
    q_c = nn_cpu._query_features(jq, de[:n])
    nn_cpu._query_features = lambda jq, de: nn._query_features(jq, de).cpu()
    want = nn_cpu.fit_predict(*sub, rng=np.random.default_rng(7), **fkw)
    ties, cands = TKNN._near_ties(q, nn.features, N2_KNN)
    ties, cands = ties.cpu().numpy(), cands.cpu().numpy()
    diff = neighbor_check(np, "config 2 fit_predict (card vs CPU, the "
                          "card's inputs)", nn.neighbors, nn_cpu.neighbors,
                          ties, cands)
    check(np.array_equal(nn.Nneighbors, nn_cpu.Nneighbors),
          "config 2: union sizes differ from the CPU's")
    for k, nm in ((0, "lmap"), (1, "levid")):
        a, b = got[1][k], want[1][k]
        err = float(np.max(np.abs(a - b) / (2e-5 + 2e-5 * np.abs(b))))
        check(err <= 1.0, f"config 2 {nm} differs from the CPU's "
                          f"({err} x tol)")
    close = np.isclose(got[0], want[0], rtol=2e-3, atol=2e-5)
    if not close.all():
        # A weight within FLIP of the cut may land on either side.
        env = [nn_cpu.predict(z, zerr, label_grid=grid,
                              wt_thresh=WT_THRESH * f)
               for f in (FLIP, 1 / FLIP)]
        tol = 2e-5 + 2e-3 * np.abs(want[0])
        check(((got[0] >= np.minimum(*env) - tol)
               & (got[0] <= np.maximum(*env) + tol)).all(),
              "config 2 PDFs differ from the CPU's beyond the "
              "threshold-flip envelope")
    check(np.allclose(got[0], pdfs[:n], rtol=2e-3, atol=2e-5),
          "config 2: 512 objects alone differ from the same rows of the "
          "whole call")
    moved = "; ".join(
        f"{what}: {int((nb != nn.neighbors).any(axis=1).sum())} rows"
        for what, nb in own.items())
    print(f"config 2 vs the CPU ({n} objects, the same draws, the card's "
          f"ensembles and query features): neighbour lists differ on "
          f"{len(diff)} rows (bar: below 1%, only among near ties; "
          f"{int(ties.sum())} rows have a pair within 1e-5 of |q|^2 + "
          f"|Y|^2), union sizes equal, PDFs {int((~close).sum())} cells "
          f"outside rtol 2e-3 / atol 2e-5, lmap and levid within 2e-5, on "
          f"every row | statistic, rows whose lists differ with the CPU's "
          f"own inputs: {moved} (query features differ by up to "
          f"{float((q.cpu() - q_c).abs().max()):.3g}) | card {card}",
          flush=True)

    t0 = time.perf_counter()
    summ, gof = nn.fit_summarize(d, de, dmask, z, zerr, label_grid=grid,
                                 k=N2_KNN, verbose=False,
                                 rng=np.random.default_rng(7))
    torch.cuda.synchronize()
    summ_s = time.perf_counter() - t0
    cols = np.stack([np.asarray(c) for est in summ[:4] for c in est]
                    + [np.asarray(c) for c in summ[4:]], axis=1)
    u = np.random.default_rng(0).random(N2_TEST)
    want_cols = TS._pack_summary(TS.pdfs_summarize(
        torch.tensor(pdfs, device="cuda"), grid, u=u)).cpu().numpy()
    s_err = float(np.max(np.abs(cols - want_cols)
                         / (2e-6 + 2e-5 * np.abs(want_cols))))
    check(s_err <= 1.0, f"config 2 fit_summarize differs from "
                        f"pdfs_summarize(fit_predict) ({s_err} x tol)")
    check(np.array_equal(gof[0], lmap), "config 2 fit_summarize lmap")
    print(f"config 2 fit_summarize: {N2_TEST} objects, wall {summ_s:.4f} s "
          f"({N2_TEST / summ_s:.6g} objects/s), 21 columns match "
          f"pdfs_summarize(fit_predict) (worst {s_err:.3g} x tol) | card "
          f"{card}", flush=True)

    # Exact ties: 64 models repeated 4 times with zero errors; each query
    # sits on a model, so its group ties at distance 0 and the next
    # group ties across the k-th place.
    rng = np.random.default_rng(3)
    base = rng.uniform(5.0, 50.0, (64, 5))
    mt = np.tile(base, (4, 1))
    nt = NearestNeighbors(mt, np.zeros_like(mt), np.ones_like(mt), K=3,
                          seed=0, verbose=False)
    q = nt.features[0][:16]
    idx = nt._search_fn(k=6, lp_norm=2, dbound=np.inf)(q)[0].cpu().numpy()
    f64 = nt.features[0].cpu().numpy().astype(float)
    for b in range(16):
        dist = ((f64 - f64[b]) ** 2).sum(axis=1)
        check(idx[b][:6].tolist()
              == np.argsort(dist, kind="stable")[:6].tolist()
              and (idx[b][6:] == -99).all(),
              f"tie case: row {b} does not take the lowest index first")
    print(f"config 2 tie case: 64 models x 4 copies, zero errors, k=6 "
          f"across K=3: lowest index first on every row; phase 11 "
          f"{time.perf_counter() - t_phase:.1f} s | card {card}",
          flush=True)


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
    from frankenz_tpu_torch.kernels import screened as SCK
    from frankenz_tpu_torch.models import BruteForce
    from frankenz_tpu_torch.ops import fused as TF
    from frankenz_tpu_torch.ops import screen as SC
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
    # Registers, spills and shared memory of the two redesigned passes
    # (nvcc -Xptxas -v on their source alone; dynamic shared memory at
    # config 4's widths).
    lib = kbuild.load()
    ptxas = {k: dict(v, dynamic_smem=smem)
             for name, v in kbuild.ptxas_report("chi2_screened.cu").items()
             for k, smem in (
                 ("chi2_brackets_screened",
                  lib.fz_chi2_brackets_screened_smem(NFILT)),
                 ("chi2_stack_screened",
                  lib.fz_chi2_stack_screened_smem(NFILT, NGRID)))
             if f"{k}_kernel" in name}
    check(set(ptxas) == {"chi2_brackets_screened", "chi2_stack_screened"},
          f"no ptxas report for the screened passes ({sorted(ptxas)})")
    print("ptxas -v: " + "; ".join(
        f"{k} {v['registers']} registers, {v['spill_stores']} / "
        f"{v['spill_loads']} bytes spill stores / loads, stack {v['stack']}"
        f", {v['dynamic_smem']} bytes dynamic shared memory at F={NFILT} "
        f"Ngrid={NGRID}" for k, v in ptxas.items()), flush=True)
    # The cluster probe: one cluster barrier, one DSMEM load, and the two
    # in a dependent loop of 40,000 rounds, for K = 2, 4, 8, 16; and the
    # clusters the card holds at once at the two chain kernels' launch
    # shapes (config 3's GNG, config 5's chain), which pick their routes.
    from frankenz_tpu_torch.kernels import gng as GG0
    from frankenz_tpu_torch.kernels import pop as PK0
    from frankenz_tpu_torch.kernels import probe as PRB
    from frankenz_tpu_torch.kernels import som as SK0
    idx = torch.cuda.current_device()
    occupancy = {
        "som_train": {k: SK0._active(idx, NSIDE3 ** 2, NFILT, 2, k)
                      for k in SK0.CLUSTER_SIZES},
        "gng_train": {k: GG0._active(idx, NMAX_G, NFILT, k)
                      for k in GG0.CLUSTER_SIZES},
        "pop_chain": {k: PK0._active(idx, NOBS5, 2 + 2 * MH_P, MH_P, k)
                      for k in PK0.cluster_sizes(NOBS5, 2 + 2 * MH_P)}}
    print("cluster_probe: " + json.dumps({
        "rounds": 40_000, "probe": PRB.cluster_probe(dev, iters=40_000),
        "max_active_clusters": occupancy, "card": card}), flush=True)

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
        # The route's pass B (K7): the models in band order, each 64-model
        # tile multiplying only its band of G; bit for bit the dense kernel
        # on the same order, against its plain version (a matmul over every
        # column); the brackets in band order equal the caller order's.
        M_c = mT.shape[1]
        bs = GK.band_sort(Gc, mT, meT)
        Gb = bs.G[:M_c, :bs.ngrid]
        bb = FM.chi2_brackets(d, de, bs.mT, bs.meT, c0=2 * a1)

        def bstack_k(thr=wthr):
            return FM.chi2_stack(d, de, bs.mT, bs.meT, Gb, shift, a1=a1,
                                 wthr=thr, bands=bs.bands)

        def bstack_p(thr=wthr):
            return FM.chi2_stack_plain(d, de, bs.mT, bs.meT, Gb, shift,
                                       a1=a1, wthr=thr, bands=bs.bands)

        (qk, rk), (qp, rp) = bstack_k(), bstack_p()
        twin = FM.chi2_stack(d, de, bs.mT, bs.meT, Gb.contiguous(), shift,
                             a1=a1, wthr=wthr)
        torch.cuda.synchronize()
        check(torch.equal(bb[0], bk[0]) and torch.equal(bb[1], bk[1]),
              f"{name}: chi2_brackets in band order differ from the "
              f"caller order's")
        check(torch.equal(qk, twin[0]) and torch.equal(rk, twin[1]),
              f"{name}: banded chi2_stack differs from the dense kernel on "
              f"the band order")
        r_abs, r_rel = rel_err(torch, rk, rp)
        check(r_rel <= TOL_SUM,
              f"{name}: banded chi2_stack weight sums differ (rel {r_rel})")
        q_row, ok = pdf_rows_close(torch, qk, qp,
                                   lambda: bstack_p(wthr * FLIP)[0],
                                   lambda: bstack_p(wthr / FLIP)[0],
                                   TOL_PDF_ROW)
        check(ok, f"{name}: banded chi2_stack PDFs differ beyond the "
                  f"threshold-flip envelope (row-normwise {q_row})")
        q_abs = float((qk - qp).abs().max())
        t = {"brackets": (median_ms(torch, brackets_k),
                          median_ms(torch, brackets_p)),
             "stack": (median_ms(torch, bstack_k),
                       median_ms(torch, bstack_p, reps=3)),
             "caller": (median_ms(torch, stack_k),
                        median_ms(torch, stack_p))}
        for kname, ab, rl, key in (("chi2_brackets", b_abs, b_rel,
                                    "brackets"),
                                   ("chi2_stack", max(q_abs, r_abs),
                                    max(q_row, r_rel), "stack")):
            results[kname][name] = dict(max_abs_err=ab, max_rel_err=rl,
                                        ms=t[key][0], plain_ms=t[key][1])
        results["chi2_stack"][name].update(
            caller_order_ms=t["caller"][0], caller_order_plain_ms=t[
                "caller"][1], caller_order_max_abs_err=max(p_abs, s_abs),
            caller_order_max_rel_err=max(p_row, s_rel),
            band_cols_mean=float((bs.bands[:, 1] - bs.bands[:, 0]).float()
                                 .mean()))
        if name == "config4":
            # Operations per pair: chi^2 6 per filter (variance 2,
            # residual, square, divide, sum) + 2 compares (pass A) or
            # + ~10 for the weight chain (pass B), and pass B's 2 Ngrid
            # for every kept weight.
            B, M = d_np.shape[0], m_np.shape[0]
            io = 4.0 * (2 * B * F + 2 * F * M)
            w = FM._weights_plain(FM._chi2_plain(d, de, mT, meT, False),
                                  shift[:, None], a1)
            kept = float((w > wthr).sum())
            del w
            results["chi2_brackets"][name].update(zip(
                ("bound_ms", "bound_by"),
                bound(float(B) * M * (6 * F + 2), io + 8.0 * B)))
            # Band order: 2 operations per nonzero G entry of each kept
            # model (the dense count, 2 Ngrid a kept pair, beside).
            keep = (FM._weights_plain(FM._chi2_plain(d, de, mT, meT, False),
                                      shift[:, None], a1) > wthr).to(
                torch.float32)
            nnz = (Gc != 0).sum(dim=1).to(torch.float32)
            kept_nnz = float((keep @ nnz).sum())
            del keep
            results["chi2_stack"][name].update(zip(
                ("bound_ms", "bound_by"),
                bound(float(B) * M * (6 * F + 10) + 2.0 * kept_nnz,
                      io + 4.0 * (float(nnz.sum()) + B * Gc.shape[1]
                                  + 2 * B))))
            results["chi2_stack"][name].update(zip(
                ("dense_bound_ms", "dense_bound_by"),
                bound(float(B) * M * (6 * F + 10) + 2.0 * Gc.shape[1] * kept,
                      io + 4.0 * (M * Gc.shape[1] + B * Gc.shape[1]
                                  + 2 * B))))
        print(f"kernel_vs_plain {name}: B={d_np.shape[0]} "
              f"M={m_np.shape[0]} F={F} Ngrid={Gc.shape[1]} | "
              f"chi2_brackets abs {b_abs:.3g} rel {b_rel:.3g} "
              f"{t['brackets'][0]:.3f} ms (plain {t['brackets'][1]:.3f} "
              f"ms), band order bit-equal | chi2_stack in band order (band "
              f"{results['chi2_stack'][name]['band_cols_mean']:.4g} columns "
              f"a tile) pdf abs {q_abs:.3g} row-rel {q_row:.3g} s rel "
              f"{r_rel:.3g} {t['stack'][0]:.3f} ms (plain "
              f"{t['stack'][1]:.3f} ms), == the dense kernel on band order "
              f"bit for bit | caller order pdf abs {p_abs:.3g} row-rel "
              f"{p_row:.3g} s rel {s_rel:.3g} {t['caller'][0]:.3f} ms "
              f"(plain {t['caller'][1]:.3f} ms) | card {card}", flush=True)
        del d, de, mT, meT, bk, bp, pk, pp, bs, Gb, bb, qk, qp, twin
        torch.cuda.empty_cache()

    # 3b. the screened trio (K2), kernels and route
    scr_results, expf, scr_fractions = screened_phase(
        torch, np, tens, card, cases, ("config4_batch", data[:BATCH], models,
                                       G))
    results.update(scr_results)

    # 4. end to end through the user entry points: the screened route
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
    for kname in SCREENED:
        check(launches[kname] > 0, f"{kname} was not launched by fit_predict")
    check(launches["chi2_brackets"] == launches["chi2_stack"] == 0,
          f"full-mask fit_predict launched the K1 pair ({launches})")
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

    # The K1 pair (``screen=False``), which BruteForce does not select:
    # one 65,536-object batch through `fused_fit_pdf` directly, beside the
    # screened route on the same batch (each warm, counts reset before).
    d_b = tens(data[:BATCH])
    de_b = tens(data_err[:BATCH])
    ones_b = tens(ones_d[:BATCH])
    walls_b = {}
    for label, kw_b in (("screened", {}), ("K1", dict(screen=False))):
        TF.fused_fit_pdf(d_b, de_b, ones_b, bf.models, bf.models_err,
                         bf.models_mask, G, **kw_b)  # warm-up
        torch.cuda.synchronize()
        KS.reset_launch_counts()
        t0 = time.perf_counter()
        TF.fused_fit_pdf(d_b, de_b, ones_b, bf.models, bf.models_err,
                         bf.models_mask, G, **kw_b)
        torch.cuda.synchronize()
        walls_b[label] = time.perf_counter() - t0
        launches_b = KS.launch_counts()
        want_k = SCREENED if label == "screened" else K1_PAIR
        for kname in SCREENED + K1_PAIR:
            check((launches_b[kname] > 0) == (kname in want_k),
                  f"{label} batch launches {launches_b}")
        if label == "K1":
            launches_k1 = launches_b
    print(f"end_to_end one {BATCH}-object full-mask batch through "
          f"fused_fit_pdf: screened (K2) wall {walls_b['screened']:.4f} s, "
          f"screen=False (K1) wall {walls_b['K1']:.4f} s, K1 launches "
          f"{ {k: launches_k1[k] for k in K1_PAIR} } | card {card}",
          flush=True)

    # kernel times at the main path's batch (no plain version fits there)
    mT, meT = tens(models.T), tens(models_err.T)
    below, above = FM.chi2_brackets(d_b, de_b, mT, meT, c0=NFILT - 2.0)
    _, shift_b = TF.lmap_and_shift(below, above, NFILT)
    ms_a = median_ms(torch, lambda: FM.chi2_brackets(
        d_b, de_b, mT, meT, c0=NFILT - 2.0), reps=3)
    # Pass B as the K1 route runs it (band order), and in the caller's
    # order beside it.
    bs_k1 = GK.band_sort(G, mT, meT)
    ms_b = median_ms(torch, lambda: FM.chi2_stack(
        d_b, de_b, bs_k1.mT, bs_k1.meT, bs_k1.G[:NMODEL, :NGRID], shift_b,
        a1=0.5 * NFILT - 1.0, wthr=wthr, bands=bs_k1.bands), reps=3)
    ms_b_caller = median_ms(torch, lambda: FM.chi2_stack(
        d_b, de_b, mT, meT, G, shift_b, a1=0.5 * NFILT - 1.0, wthr=wthr),
        reps=3)
    del bs_k1
    ms_batch = {"chi2_brackets": ms_a, "chi2_stack": ms_b}
    srt = SC.sort_and_bound(d_b, de_b, mT, meT, G, sm=512, tm=512,
                            tb=SCK.TB, ignore_model_err=False)
    sargs = (srt.d, srt.de, srt.mT, srt.meT)
    c0 = NFILT - 2.0
    seed_b = torch.minimum(srt.seed, SCK.screen_seed(
        *sargs, srt.start, width=512, c0=c0))
    gates_b = SC.stack_gates(srt, *SCK.chi2_brackets_screened(
        *sargs, srt.bounds, seed_b, c0=c0, sm=512), wt_thresh=WT_THRESH)
    ms_batch["screen_seed"] = median_ms(torch, lambda: SCK.screen_seed(
        *sargs, srt.start, width=512, c0=c0), reps=3)
    ms_batch["chi2_brackets_screened"] = median_ms(
        torch, lambda: SCK.chi2_brackets_screened(
            *sargs, srt.bounds, seed_b, c0=c0, sm=512), reps=3)
    ms_batch["chi2_stack_screened"] = median_ms(
        torch, lambda: SCK.chi2_stack_screened(
            *sargs, srt.G, gates_b.shift, srt.bounds, gates_b.visit,
            gates_b.cut_uf, gates_b.cut_dot, gates_b.ph, gates_b.cut_abs,
            a1=0.5 * NFILT - 1.0, sm=512, wthr=wthr), reps=3)
    stats_b = [float(x) for x in SC.run_fractions(srt, seed_b, gates_b)]
    kept_batch, bound_batch = screened_bounds(torch, FM, srt, gates_b,
                                              stats_b, 512, wthr)
    print(f"kernel_at_batch {BATCH}x{NMODEL}: " + ", ".join(
        f"{k} {ms_batch[k]:.3f} ms" for k in K1_PAIR + SCREENED)
        + f" (chi2_stack in band order; caller order {ms_b_caller:.3f} ms)"
        + " | screened bounds " + ", ".join(
            f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in bound_batch.items())
        + f" at run fractions A {stats_b[0]:.4f} B {stats_b[1]:.4f} dot "
        f"{stats_b[2]:.4f}; kept weights {kept_batch['kept_per_row']:.3f} "
        f"per row, {kept_batch['kept_models_per_block']:.1f} models kept by "
        f"some row per 32-row block | card {card}", flush=True)

    del d_b, de_b, ones_b, mT, meT, below, above, shift_b, srt, sargs
    del seed_b, gates_b, stats_b
    torch.cuda.empty_cache()

    # 5. masked photometry: the general kernels
    band = band_stats(torch, GK, G, [tens(x) for x in (
        models.T, models_err.T, np.ones_like(models).T)], card)
    dmask = (np.random.default_rng(2).uniform(size=(N_E2E, NFILT))
             >= P_MISSING).astype(f32)
    n_dead = int((dmask.sum(axis=1) == 0).sum())
    for kname in GENERAL + ("lnl_onepass",):
        results[kname] = {}
    for case in general_cases(np, np.random.default_rng(3), data, models,
                              dmask):
        per = general_kernel_case(torch, np, GK, TF, tens, card, G, case,
                                  bounds=case[0] == "masked_dimprior")
        for kname, r in per.items():
            results[kname][case[0]] = r
    # The table route on the fixed-scale two-pass instantiations that the
    # six cases do not hold, bit for bit the recompute route.
    log_thr = float(np.log(WT_THRESH))
    for fl in (dict(dim_prior=False), dict(ignore_model_err=True),
               dict(dim_prior=False, ignore_model_err=True),
               dict(full_mask=True, dim_prior=False, ignore_model_err=True)):
        fl = dict(dict(full_mask=False), **fl)
        dm_k = (np.ones_like(dmask[:N_KERNEL]) if fl["full_mask"]
                else dmask[:N_KERNEL])
        args_k = [tens(x) for x in (
            data[:N_KERNEL], np.full((N_KERNEL, NFILT), 0.25, f32), dm_k,
            models.T, (0.05 * models).T, np.ones_like(models).T)]
        _, tab, _ = table_route_check(torch, np, GK, args_k, G, fl, log_thr,
                                      f"table route {fl}")
        results["lnl_reduce"]["masked_dimprior"].setdefault(
            "table_ulp_other", {})[str(fl)] = tab
        print(f"table_route {fl}: B={N_KERNEL} M={NMODEL}, band order "
              f"(lnl_stack_band) == recompute route on band order bit for "
              f"bit (lmap, levid, pdf); lnl table "
              f"{tab['table_ulp']:.3g} ulp from lnl_tile_plain "
              f"({tab['table_ulp_count']} entries differ) | card {card}",
              flush=True)
        del args_k
    # The band stacks on the fixed-scale instantiations that the six
    # cases do not hold.
    for fl in (dict(dim_prior=False), dict(ignore_model_err=True),
               dict(dim_prior=False, ignore_model_err=True),
               dict(full_mask=True), dict(full_mask=True,
                                          ignore_model_err=True),
               dict(full_mask=True, dim_prior=False, ignore_model_err=True)):
        fl = dict(dict(full_mask=False), **fl)
        dm_k = (np.ones_like(dmask[:N_KERNEL]) if fl["full_mask"]
                else dmask[:N_KERNEL])
        args_k = [tens(x) for x in (
            data[:N_KERNEL], np.full((N_KERNEL, NFILT), 0.25, f32), dm_k,
            models.T, (0.05 * models).T, np.ones_like(models).T)]
        got = band_kernel_check(torch, np, GK, TF, args_k, G, fl,
                                f"band stacks {fl}")
        results["lnl_onepass"]["masked_dimprior"].setdefault(
            "other_instantiations", {})[str(fl)] = got
        print(f"band_stacks {fl}: B={N_KERNEL} M={NMODEL}: lnl_cut_stack "
              f"{got['lnl_cut_stack']:.3f} ms (row-normwise "
              f"{got['cut_row_err']:.3g}), lnl_onepass "
              f"{got['lnl_onepass']:.3f} ms ({got['onepass_row_err']:.3g}) "
              f"against their plain versions | card {card}", flush=True)
        del args_k

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
    check(launches_m["lnl_reduce"] > 0 and launches_m["lnl_stack_band"] > 0,
          f"masked fit_predict did not launch the general kernels "
          f"({launches_m})")
    # The table route alone, in band order: every reduce launch on the
    # table and every stack launch the band reader, never the dense one;
    # two chunks a 65,536-object batch.
    chunks_m = -(-BATCH // GK.table_rows(BATCH, NMODEL))
    check(launches_m["lnl_reduce_table"] == launches_m["lnl_reduce"]
          == launches_m["lnl_stack_band"] == chunks_m * -(-N_E2E // BATCH)
          and launches_m["lnl_stack"] == 0,
          f"masked fit_predict left the band-order table route "
          f"({launches_m})")
    check(all(launches_m[k] == 0 for k in K1_PAIR + SCREENED),
          f"masked fit_predict launched a full-mask kernel ({launches_m})")
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
    for kname in ("lnl_reduce_topk", "lnl_cut_stack"):
        check(launches_c[kname] > 0, f"cdf fit_predict did not launch "
                                     f"{kname} ({launches_c})")
    check(all(launches_c[k] == 0 for k in (
        "lnl_reduce", "lnl_topk", "lnl_stack", "lnl_stack_band",
        "lnl_reduce_split")),
          f"cdf fit_predict launched lnl_reduce, lnl_topk, a table stack or "
          f"the bisection ({launches_c})")
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
        for kname in ("lnl_reduce_topk", "lnl_reduce_split",
                      "lnl_cut_stack"):
            check(launches_r[kname] > 0, f"flat posterior rerun did not "
                                         f"launch {kname} ({launches_r})")
        check(launches_r["lnl_reduce"] == launches_r["lnl_topk"] == 0,
              f"flat posterior rerun launched lnl_reduce or lnl_topk "
              f"({launches_r})")
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
    _, _, vals_b, cnts_b = GK.lnl_reduce_topk(*args_b, T=8)
    cut_b, tie_b, nkeep_b, _ = TF.cdf_cut(vals_b, cnts_b, lv_b, CDF_THRESH)
    bs_b = GK.band_sort(G, *args_b[3:6])
    # The two-pass threshold route over the batch on both routes: the
    # table route (row chunks under TABLE_BYTES_MAX, one buffer, the models
    # in band order, `lnl_stack_band`) bit for bit the recompute route on
    # the same order; each route's kernels timed over the batch, and the
    # table route in the caller's order (the dense reader) beside.
    flags_b = dict(full_mask=False, dim_prior=True, ignore_model_err=False,
                   free_scale=False, sweeps=None, tm=None)
    argsb_b = list(args_b[:3]) + [bs_b.mT, bs_b.meT, bs_b.mmT]
    Gb_b = bs_b.G[:NMODEL, :NGRID].contiguous()
    lm_r, lv_r = GK.lnl_reduce(*argsb_b)
    pdf_r = GK.lnl_stack(*argsb_b, Gb_b, lm_r, lv_r, log_thr=log_thr)
    pdf_t, lm_t, lv_t = TF._table_route(*args_b, G, flags=flags_b,
                                        log_thr=log_thr, sweep_kw=None)
    torch.cuda.synchronize()
    for nm, g, w in (("lmap", lm_t, lm_r), ("levid", lv_t, lv_r),
                     ("pdf", pdf_t, pdf_r)):
        check(torch.equal(g, w), f"masked {BATCH} batch: table route {nm} "
                                 "differs from the recompute route on the "
                                 "band order")
    check(torch.equal(lm_t, lm_b), f"masked {BATCH} batch: lmap moved with "
                                   "the band order")
    lv_moved = float((lv_t - lv_b).abs().max())
    del pdf_r, pdf_t, lm_t, lv_t, lm_r, lv_r
    ms_recompute_band = median_ms(torch, lambda: GK.lnl_stack(
        *argsb_b, Gb_b, lm_b, lv_b, log_thr=log_thr), reps=3)
    del Gb_b
    ms_table_b, chunks_b, bytes_b, kept_b, kept_nnz_b = chunk_times(
        torch, np, GK, argsb_b, G, flags_b, log_thr, bs=bs_b)
    ms_caller_b = chunk_times(torch, np, GK, args_b, G, flags_b, log_thr)[0]
    ms_table_b["lnl_stack"] = ms_caller_b["lnl_stack"]
    bounds_b = table_bounds(NFILT, BATCH, NMODEL, NGRID, flags_b, kept_b, 0.0,
                            kept_nnz_b, float((G != 0).sum()))
    table_batch = {k: dict(ms=v, chunks=chunks_b, table_bytes=bytes_b,
                           batch_table_bytes=4 * BATCH
                           * GK.table_width(NMODEL),
                           kept_pairs=kept_b, bound_ms=bounds_b[k][0],
                           bound_by=bounds_b[k][1])
                   for k, v in ms_table_b.items()}
    table_batch["lnl_stack_band"].update(
        kept_nnz=kept_nnz_b, recompute_ms=ms_recompute_band,
        dense_ms=ms_caller_b["lnl_stack"],
        dense_bound_ms=bounds_b["lnl_stack_band_dense"][0],
        dense_bound_by=bounds_b["lnl_stack_band_dense"][1],
        producer_caller_order_ms=ms_caller_b["lnl_reduce"],
        levid_moved_by=lv_moved)
    # The product alone as one library call, a yardstick used nowhere in
    # the port: fp32_matmul of a dense (32,768 x 100,000) float32 weight
    # chunk by G, twice for the batch.
    w_dense = torch.rand((BATCH // 2, NMODEL), device=dev)
    table_batch["lnl_stack_band"]["matmul_ms"] = 2 * median_ms(
        torch, lambda: TK.fp32_matmul(w_dense, G), reps=3)
    del w_dense
    for kname, fn in (
            ("lnl_reduce", lambda: GK.lnl_reduce(*args_b)),
            ("lnl_reduce_split", lambda: GK.lnl_reduce_split(*args_b,
                                                             split_b)),
            ("lnl_stack", lambda: GK.lnl_stack(*args_b, G, lm_b, lv_b,
                                               log_thr=log_thr)),
            ("lnl_reduce_topk", lambda: GK.lnl_reduce_topk(*args_b, T=8)),
            ("lnl_cut_stack", lambda: GK.lnl_cut_stack(
                *args_b[:3], bs_b, cut_b, lv_b, tie_b, nkeep_b))):
        ms_batch[kname] = median_ms(torch, fn, reps=3)
    for kname in ("lnl_reduce", "lnl_stack"):
        table_batch[kname]["recompute_ms"] = ms_batch[kname]
        ms_batch[kname] = table_batch[kname]["ms"]
    ms_batch["lnl_stack_band"] = table_batch["lnl_stack_band"]["ms"]
    # The cdf mode's one walk over the batch (general_bounds' count).
    bound_batch["lnl_reduce_topk"] = bound(
        float(BATCH) * NMODEL
        * (lnl_pair_ops(NFILT, flags_b) + REDUCE_TOPK_OPS),
        4.0 * (3 * BATCH * NFILT + 3 * NFILT * NMODEL) + 72.0 * BATCH)
    print(f"kernel_at_batch {BATCH}x{NMODEL} masked: two-pass threshold "
          f"route in band order, table == recompute bit for bit over the "
          f"batch ({chunks_b} chunks, a {bytes_b / 1e9:.4g} GB table "
          f"buffer; lmap equal to the caller order's, levid moved by "
          f"{lv_moved:.3g}): table route "
          + ", ".join(f"{k} {v['ms']:.3f} ms" for k, v in table_batch.items()
                      if k != "lnl_stack")
          + f", the caller order's dense reader lnl_stack "
          f"{table_batch['lnl_stack']['ms']:.3f} ms; recompute route "
          + ", ".join(f"{k} {v['recompute_ms']:.3f} ms"
                      for k, v in table_batch.items())
          + f"; kept pairs {kept_b:.6g}, their nonzero G entries "
          f"{kept_nnz_b:.6g}; band reader bound "
          f"{table_batch['lnl_stack_band']['bound_ms']:.4f} ms "
          f"({table_batch['lnl_stack_band']['bound_by']}), dense "
          f"{table_batch['lnl_stack_band']['dense_bound_ms']:.4f} ms; the "
          f"product alone as fp32_matmul of dense weights by G "
          f"{table_batch['lnl_stack_band']['matmul_ms']:.3f} ms"
          + " | " + ", ".join(f"{k} {ms_batch[k]:.3f} ms" for k in (
              "lnl_reduce_split", "lnl_reduce_topk", "lnl_cut_stack"))
          + f" | card {card}", flush=True)
    # K4: one walk against lnl_reduce + lnl_stack keeping every weight.
    ms_batch["lnl_onepass"] = median_ms(
        torch, lambda: GK.lnl_onepass(*args_b[:3], bs_b), reps=3)

    def reduce_and_stack_all():
        lm, lv = GK.lnl_reduce(*args_b)
        return GK.lnl_stack(*args_b, G, lm, lv, log_thr=-np.inf)

    ms_two = median_ms(torch, reduce_and_stack_all, reps=3)
    print(f"kernel_at_batch {BATCH}x{NMODEL} masked, no weight threshold: "
          f"lnl_onepass {ms_batch['lnl_onepass']:.3f} ms, lnl_reduce + "
          f"lnl_stack keeping every weight {ms_two:.3f} ms | card {card}",
          flush=True)
    del args_b, lm_b, lv_b, split_b, vals_b, cnts_b, cut_b, tie_b, nkeep_b
    del bs_b, argsb_b
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
                per = general_kernel_case(
                    torch, np, GK, TF, tens, card, G8, case, plain_reps=1,
                    bounds=cname in ("fs_me_full_dimprior",
                                     "fs_ime_masked_dimprior"))
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
        for kname in K1_PAIR + SCREENED + tuple(absent):
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
        "config 8 fit_predict", absent=("lnl_onepass", "lnl_stack_band"))
    # The table route alone: `scale_sweeps` writes the lnl table, which
    # `lnl_reduce` and `lnl_stack` read.
    check(all(launches8[k + "_table"] == launches8[k] for k in (
        "scale_sweeps", "lnl_reduce", "lnl_stack")),
          f"config 8 fit_predict left the table route ({launches8})")
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
            ("wt_thresh", {}, ("lnl_reduce", "lnl_stack_band")),
            ("cdf", dict(wt_thresh=None, cdf_thresh=CDF_THRESH),
             ("lnl_reduce_topk", "lnl_cut_stack")),
            ("none", dict(wt_thresh=None, cdf_thresh=None),
             ("lnl_onepass",))):
        kw9 = dict(fp_kw, lprob_kwargs=lkw9, **extra)
        what = f"free-scale masked fit_predict ({label})"
        bf.fit_predict(*(x[:4_096] for x in call9[:3]), zlabels, zerrs,
                       **kw9)  # warm-up
        torch.cuda.synchronize()
        out9, walls9[label], l9 = drive(
            call9, kw9, expect, what, absent=("scale_sweeps",) + tuple(
                k for k in GENERAL + ("lnl_onepass", "lnl_topk")
                if k not in expect))
        check((l9["lnl_reduce_table"] == l9["lnl_reduce"]
               == l9["lnl_stack_band"]) if label == "wt_thresh"
              else l9["lnl_reduce_table"] == 0,
              f"{what}: the reduce ran on the wrong route ({l9})")
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
        ("lnl_reduce_topk", "lnl_reduce_split", "lnl_cut_stack"),
        "free-scale flat-posterior rerun",
        absent=("scale_sweeps", "lnl_reduce", "lnl_topk", "lnl_stack_band"))
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
        absent=("scale_sweeps", "lnl_topk") + GENERAL)
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

    # 7. free-scale kernel times at config 8's batch
    args8 = [tens(data8), tens(de8), tens(ones8), mT8,
             bf.models_err.T.contiguous(), bf.models_mask.T.contiguous()]
    fl8 = dict(full_mask=True, free_scale=True, sweeps=sw8,
               tm=TF.group_width(NMODEL, 512))
    lm8, lv8 = GK.lnl_reduce(*args8, **fl8)
    bs8 = GK.band_sort(G8, *args8[3:6])
    # The two-pass threshold route on both routes at config 8's batch (one
    # chunk): the table route bit for bit the recompute route, the sweep
    # table unchanged; each route's scale_sweeps, lnl_reduce and lnl_stack.
    flags8 = dict(full_mask=True, dim_prior=True, ignore_model_err=False,
                  free_scale=True)
    sk8 = dict(tm=fl8["tm"], full_mask=True)
    pdf8 = GK.lnl_stack(*args8, G8, lm8, lv8, log_thr=log_thr, **fl8)
    sw_t, lm_t, lv_t, pdf_t, tab8 = table_route(torch, GK, args8, G8, flags8,
                                                log_thr, sk8)
    torch.cuda.synchronize()
    for nm, g, w in (("sweep table", sw_t, sw8), ("lmap", lm_t, lm8),
                     ("levid", lv_t, lv8), ("pdf", pdf_t, pdf8)):
        check(torch.equal(g, w), f"config 8 {N8} batch: table route {nm} "
                                 "differs from the recompute route")
    check(bool(torch.isnan(tab8[:, NMODEL:]).all()),
          "config 8: the table was written past M")
    del sw_t, lm_t, lv_t, pdf_t, tab8, pdf8
    torch.cuda.empty_cache()
    ms_table8, chunks8, bytes8, kept8, _ = chunk_times(
        torch, np, GK, args8, G8, flags8, log_thr, sk8)
    bounds8 = table_bounds(NFILT, N8, NMODEL, NGRID, dict(flags8, tm=sk8["tm"]),
                           kept8, float(sw8.float().mean()))
    for kname, fn in (
            ("scale_sweeps", lambda: GK.scale_sweeps(
                *args8, tm=fl8["tm"], full_mask=True)),
            ("lnl_reduce_fs", lambda: GK.lnl_reduce(*args8, **fl8)),
            ("lnl_stack_fs", lambda: GK.lnl_stack(
                *args8, G8, lm8, lv8, log_thr=log_thr, **fl8)),
            ("lnl_onepass_fs", lambda: GK.lnl_onepass(*args8[:3], bs8,
                                                       **fl8))):
        ms_batch[kname] = median_ms(torch, fn, reps=3)
    for kname, k8 in (("scale_sweeps", "scale_sweeps"),
                      ("lnl_reduce", "lnl_reduce_fs"),
                      ("lnl_stack", "lnl_stack_fs")):
        table_batch[k8] = dict(ms=ms_table8[kname], chunks=chunks8,
                               table_bytes=bytes8,
                               batch_table_bytes=4 * N8
                               * GK.table_width(NMODEL),
                               recompute_ms=ms_batch[k8], kept_pairs=kept8,
                               bound_ms=bounds8[kname][0],
                               bound_by=bounds8[kname][1])
        ms_batch[k8] = ms_table8[kname]
    print(f"kernel_at_batch {N8}x{NMODEL} config 8: two-pass threshold "
          f"route, table == recompute bit for bit ({chunks8} chunk(s), a "
          f"{bytes8 / 1e9:.4g} GB table): table route " + ", ".join(
              f"{k} {table_batch[k]['ms']:.3f} ms" for k in (
                  "scale_sweeps", "lnl_reduce_fs", "lnl_stack_fs"))
          + ", recompute route " + ", ".join(
              f"{k} {table_batch[k]['recompute_ms']:.3f} ms" for k in (
                  "scale_sweeps", "lnl_reduce_fs", "lnl_stack_fs"))
          + f", lnl_onepass_fs {ms_batch['lnl_onepass_fs']:.3f} ms | card "
          f"{card}", flush=True)
    del args8, lm8, lv8, sw8, bs8

    # 8. SOM (config 3 without GNG)
    som_entries, data3 = som_phase(torch, np, KS, tens, card)

    # 9. GNG (config 3's other half)
    gng_entry = gng_phase(torch, np, KS, tens, card, *data3)

    # 10. the samplers (config 5)
    pop_entry = sampler_phase(torch, np, KS, tens, card)

    # 11. config 2: the mock catalog and NearestNeighbors (torch only:
    # no kernel of the table may launch)
    KS.reset_launch_counts()
    knn_phase(torch, np, card)
    launches11 = {k: v for k, v in KS.launch_counts().items() if v}
    check(not launches11, f"config 2 launched kernels: {launches11}")

    # 12. results
    replaces = {"chi2_brackets": "frankenz_tpu/ops/fused.py:918",
                "chi2_stack": "frankenz_tpu/ops/fused.py:980",
                "lnl_reduce": "frankenz_tpu/ops/fused.py:599",
                # No Pallas kernel: the JAX fitter's XLA-sort rerun.
                "lnl_reduce_split": "frankenz_tpu/models/bruteforce.py:852",
                "lnl_stack": "frankenz_tpu/ops/fused.py:634",
                # The same kernel with its band skip (:190-240, K7).
                "lnl_stack_band": "frankenz_tpu/ops/fused.py:634",
                "lnl_reduce_topk": "frankenz_tpu/ops/fused.py:721",
                "lnl_cut_stack": "frankenz_tpu/ops/fused.py:779",
                "lnl_onepass": "frankenz_tpu/ops/fused.py:670"}
    replaces.update({"screen_seed": "frankenz_tpu/ops/fused.py:1249",
                     "chi2_brackets_screened": "frankenz_tpu/ops/fused.py:1272",
                     "chi2_stack_screened": "frankenz_tpu/ops/fused.py:1308"})
    # The pair's launches: the screen=False batch (BruteForce runs K2).
    main_launches = {"chi2_brackets": launches_k1["chi2_brackets"],
                     "chi2_stack": launches_k1["chi2_stack"],
                     **{k: launches[k] for k in SCREENED},
                     "lnl_reduce": launches_m["lnl_reduce"],
                     "lnl_reduce_split": launches_r["lnl_reduce_split"],
                     "lnl_stack_band": launches_m["lnl_stack_band"],
                     "lnl_reduce_topk": launches_c["lnl_reduce_topk"],
                     "lnl_cut_stack": launches_c["lnl_cut_stack"],
                     "lnl_onepass": launches10["lnl_onepass"],
                     "lnl_reduce_table": launches_m["lnl_reduce_table"]}
    # The free-scale instantiations (csrc/lnl_freescale.cu: the `_fs`
    # entry points and the sweep counts) replace the same Pallas kernels
    # with `_lnl_tile`'s free-scale branch (ops/fused.py:316-596); their
    # launches are those of the free-scale runs (config 8, the masked
    # batch under three weight selections, the flat-posterior rerun).
    replaces["scale_sweeps"] = "frankenz_tpu/ops/fused.py:452"
    main_launches["scale_sweeps"] = launches_fs["scale_sweeps"]
    main_launches["scale_sweeps_table"] = launches_fs["scale_sweeps_table"]
    for kname in GENERAL + ("lnl_onepass",):
        replaces[kname + "_fs"] = replaces[kname]
        main_launches[kname + "_fs"] = launches_fs[kname]
    for kname in ("lnl_reduce", "lnl_stack"):
        main_launches[kname + "_fs_table"] = launches_fs[kname + "_table"]
    # The fixed-scale dense stack (recompute, or `lnl_stack_read` on a
    # caller-order table) runs on no main path: the table route reads in
    # band order.  It is the twin phases 5-7 hold the band reader to, timed
    # there as `lnl_stack_band`'s `dense_ms`; the caller-order reader that
    # config 8 runs is `lnl_stack_fs`.
    del replaces["lnl_stack"]
    kernels = []
    for kname in replaces:
        per = results[kname]
        free = kname == "scale_sweeps" or kname.endswith("_fs")
        ref = per["config4" if kname in K1_PAIR + SCREENED else
                  "fs_ime_masked_dimprior" if kname == "lnl_stack_band_fs"
                  else "fs_me_full_dimprior" if free else "masked_dimprior"]
        check(main_launches[kname] > 0,
              f"{kname} was launched no time by the end-to-end runs")
        entry = {
            "name": kname, "route": "cuda",
            "source": ("frankenz_tpu_torch/csrc/chi2_fullmask.cu"
                       if kname in K1_PAIR else
                       "frankenz_tpu_torch/csrc/chi2_screened.cu"
                       if kname in SCREENED else
                       "frankenz_tpu_torch/csrc/lnl_freescale.cu" if free
                       else "frankenz_tpu_torch/csrc/lnl_general.cu"),
            "replaces": replaces[kname], "launches": main_launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in per.values()),
            "ms": ref["ms"], "plain_ms": ref["plain_ms"],
            "bound_ms": ref["bound_ms"], "bound_by": ref["bound_by"],
            # No one PyTorch call computes a likelihood grid reduced,
            # thresholded and stacked (screened or not): timed yardstick
            # none.
            "library_ms": None, "cases": per}
        if kname in SCREENED:
            # bound_ms counts the pairs that this run's gates admit.
            entry["run_fractions"] = ref["run_fractions"]
            entry["route_run_fractions"] = scr_fractions
        if kname in ms_batch:
            entry[f"ms_batch_{N8 if free else BATCH}"] = ms_batch[kname]
        if kname in table_batch:
            # Rows 6-7 (and the sweeps) on the two-pass threshold route:
            # the table route's kernel; the recompute route's beside it.
            tb, n = table_batch[kname], N8 if free else BATCH
            entry.update({
                "lnl_route": "table",
                "source": TABLE_SOURCES[kname],
                "table_launches": main_launches[
                    kname if kname == "lnl_stack_band" else kname + "_table"],
                "recompute_ms": ref["recompute_ms"],
                "recompute_bound_ms": ref.get("recompute_bound_ms"),
                f"chunks_batch_{n}": tb["chunks"],
                f"table_bytes_batch_{n}": tb["table_bytes"],
                f"table_bytes_whole_batch_{n}": tb["batch_table_bytes"],
                f"kept_pairs_batch_{n}": tb["kept_pairs"],
                f"bound_ms_batch_{n}": tb["bound_ms"],
                f"bound_by_batch_{n}": tb["bound_by"],
                f"recompute_ms_batch_{n}": tb["recompute_ms"]})
        if kname in bound_batch:
            entry[f"bound_ms_batch_{BATCH}"] = bound_batch[kname][0]
            entry[f"bound_by_batch_{BATCH}"] = bound_batch[kname][1]
        if kname.startswith("lnl_stack_band") or kname == "chi2_stack":
            # Rows 7 and 2 in band order (K7): bound_ms counts each kept
            # model's nonzero G entries, dense_bound_ms 2 Ngrid a kept pair;
            # the dense reader's (caller order) time beside.
            entry.update(band=band, dense_bound_ms=ref["dense_bound_ms"],
                         dense_bound_by=ref["dense_bound_by"])
        if kname.startswith("lnl_stack_band"):
            entry.update(source=TABLE_SOURCES[kname],
                         dense_reader_ms=ref["dense_ms"],
                         recompute_band_order_ms=ref["recompute_ms"])
            if kname in table_batch:
                entry.update({f"{k}_batch_{BATCH}": table_batch[kname][k]
                              for k in ("dense_ms", "dense_bound_ms",
                                        "dense_bound_by", "kept_nnz",
                                        "levid_moved_by", "matmul_ms")})
        if kname == "chi2_stack":
            entry.update(caller_order_ms=ref["caller_order_ms"],
                         caller_order_plain_ms=ref["caller_order_plain_ms"],
                         **{f"caller_order_ms_batch_{BATCH}": ms_b_caller})
        if kname.replace("_fs", "") in BAND:
            # Rows 8 and 10: the band kernels (K7) over the models in band
            # order; bound_ms counts each kept model's nonzero G entries,
            # dense_bound_ms 2 Ngrid a kept pair.
            entry.update(source="frankenz_tpu_torch/csrc/lnl_band.cuh",
                         band=band, dense_bound_ms=ref["dense_bound_ms"],
                         dense_bound_by=ref["dense_bound_by"])
        if kname == "chi2_stack_screened":
            entry.update({f"{k}_batch_{BATCH}": v
                          for k, v in kept_batch.items()})
        if kname in ptxas:
            entry["ptxas"] = ptxas[kname]
        kernels.append(entry)
    kernels.extend(som_entries)
    kernels.append(gng_entry)
    kernels.append(pop_entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
