"""The full-mask two-pass pair (K1: `chi2_brackets`, `chi2_stack`)
against an earlier tree's, in turns.

    python -m frankenz_tpu_torch.tools.ab_fullmask --ref-tree DIR
        [--out DIR] [--reps N] [--stamps] [--no-walls]

Run from the root of a checkout on a machine with a CUDA card and
`nvcc`.  DIR is an earlier commit's tree (e.g. ``git archive <commit>
frankenz_tpu_torch | tar -x -C build/ab/ref``) whose
``frankenz_tpu_torch/csrc/chi2_fullmask.cu`` holds the first design of the
pair (one thread an object in pass A; a thread a grid column in pass B,
its launch taking a thread count); it is compiled alone into its own
library.  At config-4 widths (chip_smoke.py's generator: 5 filters,
100,000 models, the 301-point `PDFDict` grid, wt_thresh 1e-3), over the
models in band order (`band_sort`, pass B with each tile's band, as the
`screen=False` route runs it) and in the caller's order, at B = 2,048 and
65,536, it
- checks `below`, `above`, pdf and s of the package's kernels against the
  earlier tree's bit for bit, and at 2,048 in band order against the
  plain versions (brackets bit for bit, s 1e-5 relative, PDFs 1e-5 of
  each row's largest value);
- times earlier, package, package, earlier (CUDA events, median of
  `--reps` launches each);
- does the same at 65,536 in band order with a few rows whose every
  chi^2 clamps (`OUTLIER_ROWS`, one a CTA: each keeps every model), and
  at both sizes in band order at F_LOG = 20 filters (the log form, the
  run-time instantiation);
- prints `nvcc -Xptxas -v`'s registers, spills and stack of every build,
  the launch shapes, and each pass's SASS issue floor: the instructions
  a pair of the F = 5 instantiation's loop (`cuobjdump -sass`), times
  the pairs, over 132 SMs x 4 schedulers at the card's maximum SM clock;
- with ``--stamps`` builds pass B with -DFZ_STAMPS and prints the
  cycles a chunk of a weight warp's weights and barrier wait, a dot
  warp's dot and barrier wait, and the sum warp's Kahan chain and barrier
  wait, at both sizes;
- unless ``--no-walls``, times `fused_fit_pdf(screen=False)` over two
  65,536-object batches (each read back) in each tree, each in its own
  process, in turns (earlier, package, package, earlier; a warm-up and 3
  walls a process), with a SHA-256 of the PDFs, lmap and levid, which
  must be one digest for both trees.
It prints one JSON line and writes it to ``DIR/ab_fullmask.json``; it
exits non-zero when a check fails.
"""

import argparse
import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

from . import sweep_stats as SS

NMODEL, NFILT, NGRID, N_E2E, WT_THRESH = 100_000, 5, 301, 131_072, 1e-3
SIZES = (2_048, 65_536)
SOURCE = "chi2_fullmask.cu"
F_LOG = 20  # the log form's widths (a1 = 9 > 8.5), run-time instantiation
# Rows of the 65,536 batch whose every chi^2 clamps (one a CTA).
OUTLIER_ROWS = (5, 16_389, 32_773, 49_157)
STAMP_PARTS = ("weight warp ring wait and weights",
               "weight warp barrier wait", "dot warp dot",
               "dot warp barrier wait", "sum warp Kahan chain",
               "sum warp barrier wait")
# The package's entry points (csrc/chi2_fullmask.cu), argument codes as in
# sweep_stats.bind, and the first design's two launches.
ENTRIES = (
    ("fz_chi2_brackets_smem", ["I"]), ("fz_chi2_stack_smem", ["I", "I"]),
    ("fz_chi2_brackets_chunk", []), ("fz_chi2_stack_chunk", ["I", "I"]),
    ("fz_chi2_brackets_occupancy", ["I"]),
    ("fz_chi2_brackets", ["P"] * 6 + ["I"] * 6 + ["F", "I", "P"]),
    ("fz_chi2_stack", ["P"] * 5 + ["I"] + ["P"] * 4 + ["I"] * 5
     + ["F", "I", "F", "I", "P"]),
    ("fz_chi2_stack_stamps", ["P"]))
REF_ENTRIES = (
    ("fz_chi2_brackets", ["P"] * 6 + ["I"] * 3 + ["F", "I", "P"]),
    ("fz_chi2_stack", ["P"] * 5 + ["I"] + ["P"] * 4 + ["I"] * 4
     + ["F", "I", "F", "I", "I", "P"]))
# `fused_fit_pdf(screen=False)` over two batches in one tree (its own
# process): a warm-up, 3 walls, and a SHA-256 of PDFs, lmap, levid.
_WALLS = r"""
import hashlib, json, time
import numpy as np, torch
from frankenz_tpu_torch.ops import fused as TF
from frankenz_tpu_torch.ops import kde as TK
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
M, F, NG, N, BATCH = %d, %d, %d, %d, %d
f32 = np.float32
rng = np.random.default_rng(0)
models = rng.uniform(1, 10, (M, F)).astype(f32)
zl = rng.uniform(0, 3.5, M)
data = rng.uniform(1, 10, (N, F)).astype(f32)
dev = torch.device("cuda")
pdict = TK.PDFDict(np.linspace(0.0, 4.0, NG), np.linspace(0.01, 0.5, 100))
G = TK.kernel_matrix_dict(pdict, *pdict.fit(zl, np.full(M, 0.1)),
                          device=dev).to(torch.float32).contiguous()
m, me = torch.tensor(models, device=dev), torch.tensor(0.05 * models, device=dev)
mm = torch.ones_like(m)
d = torch.tensor(data, device=dev)
de, ones = torch.full_like(d, 0.25), torch.ones_like(d)
def run():
    out = []
    for b0 in range(0, N, BATCH):
        sl = slice(b0, b0 + BATCH)
        pdf, lmap, levid = TF.fused_fit_pdf(d[sl], de[sl], ones[sl], m, me,
                                            mm, G, screen=False)
        pdf = pdf / pdf.sum(dim=1, keepdim=True).clamp_min(1e-30)
        out.append([x.cpu().numpy() for x in (pdf, lmap, levid)])
    return out
run()
torch.cuda.synchronize()
walls = []
for _ in range(3):
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
digest = hashlib.sha256()
for batch in out:
    for x in batch:
        digest.update(np.ascontiguousarray(x).tobytes())
print("WALLS " + json.dumps({"walls": walls, "sha256": digest.hexdigest()}),
      flush=True)
"""


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "nvidia-smi unavailable"


def _bind(path, entries):
    lib = ctypes.CDLL(str(path))
    types = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float}
    for name, codes in entries:
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [types[c] for c in codes]
            getattr(lib, name).restype = ctypes.c_int
    return lib


def fast_path(loop):
    """The instructions of one pass through a loop on its fast path: the
    fall-through of every conditional branch (the first of the variants
    the compiler lays out one after another), the target of every
    unconditional forward branch, and past every region that a conditional
    forward branch skips and that holds a CALL (the IEEE slow paths, and
    the kernels' fallback group around them)."""
    end = loop[-1][0]
    out, skip_to = [], None
    for addr, txt, tgt in loop:
        if skip_to is not None and addr < skip_to:
            continue
        skip_to = None
        out.append(txt)
        if tgt is None or not addr < tgt <= end:
            continue
        if not txt.startswith("@") or any(
                "CALL" in t for a, t, _ in loop if addr < a < tgt):
            skip_to = tgt
    return out


def parse_k1_sass(text, F=NFILT):
    """`k1_sass` on cuobjdump's text."""
    out = {}
    for key, kernel, need_ex2 in (("chi2_brackets", "chi2_brackets_kernel",
                                   False),
                                  ("chi2_stack", "chi2_stack_kernel", True)):
        loops, name = SS.sass_loops(text, kernel, f"ILi{F}E")
        found = []
        for lp in loops:
            fast = fast_path(lp)
            rcp = sum("MUFU.RCP" in t for t in fast)
            if rcp >= 4 * F and (not need_ex2
                                 or any("MUFU.EX2" in t for t in fast)):
                found.append({"instructions": len(lp),
                              "fast_instructions": len(fast),
                              "pairs": rcp // F,
                              "per_pair": len(fast) / (rcp // F),
                              "mufu_ex2": sum("MUFU.EX2" in t
                                              for t in fast),
                              "mufu_rsq": sum("MUFU.RSQ" in t
                                              for t in fast)})
        if not found:
            return {"error": f"no {key} loop with {4 * F} divides on its "
                             f"fast path", "function": name}
        out[key] = dict(min(found, key=lambda x: x["instructions"]),
                        function=name)
    return out


def k1_sass(build, lib_path=None, F=NFILT):
    """Instructions a pair of each pass's F-compiled instantiation in
    `cuobjdump -sass` of `lib_path` (default the package's library): the
    shortest loop whose fast path (`fast_path`) holds at least 4 F divides
    (MUFU.RCP; pass B also an exp), its fast path's instructions over the
    pairs it runs (its divides / F).  {pass: {"instructions" (the whole
    loop), "fast_instructions", "pairs", "per_pair", "function"}} or
    {"error": ...}."""
    tool = SS._cuobjdump(build)
    if tool is None:
        return {"error": "no cuobjdump"}
    run = subprocess.run([tool, "-sass",
                          str(lib_path or build.library_path())],
                         capture_output=True, text=True)
    if run.returncode != 0:
        return {"error": run.stderr[-500:]}
    return parse_k1_sass(run.stdout, F)


def issue_floors(sass, B, M, sms, clock_mhz):
    """{pass: ms} the schedulers need to issue B M pairs at the SASS
    count's instructions a pair (32 pairs a warp instruction)."""
    return {k: SS.issue_floor(B * M / 32, v["per_pair"], sms, clock_mhz)
            for k, v in sass.items()}


def _walls(tree):
    env = dict(os.environ, PYTHONPATH=str(tree))
    run = subprocess.run(
        [sys.executable, "-c",
         _WALLS % (NMODEL, NFILT, NGRID, N_E2E, N_E2E // 2)],
        cwd=str(tree), env=env, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"screen=False walls in {tree} failed:\n"
                           f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    line = [x for x in run.stdout.splitlines() if x.startswith("WALLS ")]
    return json.loads(line[-1][len("WALLS "):])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref-tree", required=True)
    ap.add_argument("--out", default="build/ab_fullmask")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--no-walls", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..kernels import build
    from ..kernels import fullmask as FM
    from ..kernels import general as GK
    from ..ops import fused as TF
    from ..ops import kde

    if not torch.cuda.is_available():
        raise SystemExit("ab_fullmask needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = _card()
    print(card, flush=True)
    dev = torch.device("cuda")
    ref_src = Path(args.ref_tree) / "frankenz_tpu_torch" / "csrc" / SOURCE
    builds = {"ref": ([], ref_src), "package": ([], None)}
    if args.stamps:
        builds["stamps"] = (["-DFZ_STAMPS"], None)
    procs = {name: SS.start(build, f"k1_{name}", flags,
                            src or build._SRC_DIR / SOURCE)
             for name, (flags, src) in builds.items()}
    build.build()
    pkg = build.load()
    libs, ptxas = {}, {}
    for name, (proc, path) in procs.items():
        found = build.parse_ptxas(SS.finish(proc, name))
        ptxas[name] = {k: v for k, v in found.items()
                       if "chi2_brackets_kernel" in k
                       or "chi2_stack_kernel" in k}
        libs[name] = _bind(path, REF_ENTRIES if name == "ref" else ENTRIES)
    sass = k1_sass(build)
    clock = SS.max_sm_clock()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if "error" in sass or clock is None:
        raise SystemExit(f"no SASS issue floor: {sass}, clock {clock}")
    print(f"ptxas -v: {json.dumps(ptxas)} | SASS a pair: " + ", ".join(
        f"{k} {v['per_pair']:.2f} ({v['fast_instructions']} of the loop's "
        f"{v['instructions']} instructions on the fast path, {v['pairs']} "
        f"pairs a loop)" for k, v in sass.items())
        + f" | card {card}", flush=True)

    f32 = np.float32
    rng = np.random.default_rng(0)
    models = rng.uniform(1, 10, (NMODEL, NFILT)).astype(f32)
    zl = rng.uniform(0, 3.5, NMODEL)
    pdict = kde.PDFDict(np.linspace(0.0, 4.0, NGRID),
                        np.linspace(0.01, 0.5, 100))
    G = kde.kernel_matrix_dict(pdict, *pdict.fit(zl, np.full(NMODEL, 0.1)),
                               device=dev).to(torch.float32).contiguous()
    data = rng.uniform(1, 10, (N_E2E, NFILT)).astype(f32)
    # The log form's widths (F_LOG filters, a1 past 8.5), on the same G.
    rng_log = np.random.default_rng(1)
    models_log = rng_log.uniform(1, 10, (NMODEL, F_LOG)).astype(f32)
    data_log = rng_log.uniform(1, 10, (max(SIZES), F_LOG)).astype(f32)

    def model_orders(m_np):
        mT = torch.tensor(m_np.T.copy(), device=dev)
        meT = torch.tensor((0.05 * m_np).astype(f32).T.copy(), device=dev)
        bs = GK.band_sort(G, mT, meT)
        return {"band": (bs.mT, bs.meT, bs.G[:NMODEL, :NGRID], bs.bands),
                "caller": (mT, meT, G, None)}

    orders = model_orders(models)
    wthr = float(np.exp(np.log(WT_THRESH)))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {rc}")

    def ref_a(d, de, m, me, _g, _bands):
        B, F = d.shape
        below, above = torch.empty(B, device=dev), torch.empty(B, device=dev)
        check(libs["ref"].fz_chi2_brackets(
            d.data_ptr(), de.data_ptr(), m.data_ptr(), me.data_ptr(),
            below.data_ptr(), above.data_ptr(), B, NMODEL, F, F - 2.0, 0,
            stream), "earlier chi2_brackets")
        return below, above

    def ref_b(d, de, m, me, g, bands, shift):
        B, F = d.shape
        pdf = torch.empty((B, NGRID), device=dev)
        s = torch.empty(B, device=dev)
        check(libs["ref"].fz_chi2_stack(
            d.data_ptr(), de.data_ptr(), m.data_ptr(), me.data_ptr(),
            g.data_ptr(), g.stride(0),
            None if bands is None else bands.data_ptr(), shift.data_ptr(),
            pdf.data_ptr(), s.data_ptr(), B, NMODEL, F, NGRID,
            0.5 * F - 1.0, 1, wthr, 0, min(-(-NGRID // 32) * 32, 512),
            stream), "earlier chi2_stack")
        return pdf, s

    @contextlib.contextmanager
    def using(name):
        """The package's wrappers launching build `name`'s kernels."""
        saved = build._lib
        build._lib = libs[name]
        FM._per_sm.cache_clear()
        try:
            yield
        finally:
            build._lib = saved
            FM._per_sm.cache_clear()

    def new_a(d, de, m, me, _g, _bands):
        return FM.chi2_brackets(d, de, m, me, c0=d.shape[1] - 2.0)

    def new_b(d, de, m, me, g, bands, shift):
        return FM.chi2_stack(d, de, m, me, g, shift, a1=0.5 * d.shape[1] - 1,
                             wthr=wthr, bands=bands)

    def median_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1))
        return statistics.median(times)

    def turns(old, new):
        r1, n1, n2, r2 = median_ms(old), median_ms(new), median_ms(new), \
            median_ms(old)
        return [r1, r2], [n1, n2]

    def same(a, b):
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(a, b))

    def case(d, de, m, me, g, bands, plain=False):
        """Both passes of both trees on one input: the bit checks (and,
        with `plain`, against the plain versions) and the times in
        turns."""
        F = d.shape[1]
        a = (d, de, m, me, g, bands)
        bn, br = new_a(*a), ref_a(*a)
        _, shift = TF.lmap_and_shift(*bn, F)
        pn, pr = new_b(*a, shift), ref_b(*a, shift)
        torch.cuda.synchronize()
        chk = {"brackets_equal_ref": same(bn, br),
               "pdf_s_equal_ref": same(pn, pr)}
        if plain:
            bp = FM.chi2_brackets_plain(d, de, m, me, c0=F - 2.0)
            pp, sp = FM.chi2_stack_plain(d, de, m, me, g, shift,
                                         a1=0.5 * F - 1, wthr=wthr,
                                         bands=bands)
            chk["brackets_equal_plain"] = same(bn, bp)
            chk["s_rel_vs_plain"] = float(
                ((pn[1] - sp).abs() / sp.abs().clamp_min(1e-30)).max())
            scale = pp.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
            chk["pdf_rowrel_vs_plain"] = float(
                ((pn[0] - pp).abs() / scale).max())
            del bp, pp, sp
        good = (chk["brackets_equal_ref"] and chk["pdf_s_equal_ref"]
                and chk.get("brackets_equal_plain", True)
                and chk.get("s_rel_vs_plain", 0.0) <= 1e-5
                and chk.get("pdf_rowrel_vs_plain", 0.0) <= 1e-5)
        times = {}
        for kname, fa, fb in (
                ("chi2_brackets", lambda: ref_a(*a), lambda: new_a(*a)),
                ("chi2_stack", lambda: ref_b(*a, shift),
                 lambda: new_b(*a, shift))):
            r, n = turns(fa, fb)
            times[kname] = {"ref_ms": r, "package_ms": n}
        return {"checks": chk, "ok": good, "times": times}

    def show(label, res):
        print(f"ab_fullmask {label}: {json.dumps(res['checks'])} | "
              + " | ".join(f"{k} earlier {t['ref_ms'][0]:.3f}/"
                           f"{t['ref_ms'][1]:.3f} ms, package "
                           f"{t['package_ms'][0]:.3f}/"
                           f"{t['package_ms'][1]:.3f} ms"
                           for k, t in res["times"].items())
              + f" | card {card}", flush=True)

    per_sm = pkg.fz_chi2_brackets_occupancy(NFILT)
    chunk_a = pkg.fz_chi2_brackets_chunk()
    report = {"card": card, "ptxas": ptxas, "sass": sass,
        "max_sm_clock_mhz": clock, "sms": sms,
        "brackets_ctas_per_sm": per_sm, "sizes": {}}
    ok = True
    for B in SIZES:
        d = torch.tensor(data[:B], device=dev)
        de = torch.full_like(d, 0.25)
        nsplit, per = FM.brackets_splits(B, NMODEL, sms, per_sm, chunk_a)
        res = {"shapes": {
                   "chi2_brackets": {"grid": [-(-B // 32), nsplit],
                                     "threads": 256, "models_a_split": per,
                                     "ctas_per_sm": per_sm},
                   "chi2_stack": {"grid": [-(-B // 32),
                                           -(-NGRID // 320)],
                                  "threads": 512,
                                  "chunk": pkg.fz_chi2_stack_chunk(
                                      NFILT, NGRID)}},
               "issue_floor_ms": issue_floors(sass, B, NMODEL, sms, clock)}
        for order, (m, me, g, bands) in orders.items():
            res[order] = case(d, de, m, me, g, bands,
                              plain=B == SIZES[0] and order == "band")
            ok = ok and res[order]["ok"]
            show(f"B={B} {order} order", res[order])
        if B == SIZES[-1]:
            # A few rows whose every chi^2 clamps keep every model: one
            # such row a CTA, in band order.
            dc = d.clone()
            dc[list(OUTLIER_ROWS)] = 1e6
            res["outliers"] = dict(case(dc, de, *orders["band"]),
                                   rows=list(OUTLIER_ROWS))
            ok = ok and res["outliers"]["ok"]
            show(f"B={B} band order, rows {list(OUTLIER_ROWS)} all clamped",
                 res["outliers"])
            del dc
        if args.stamps:
            lib = libs["stamps"]
            cyc = (ctypes.c_ulonglong * 8)()
            m, me, g, bands = orders["band"]
            a = (d, de, m, me, g, bands)
            shift = TF.lmap_and_shift(*new_a(*a), NFILT)[1]
            with using("stamps"):
                check(lib.fz_chi2_stack_stamps(cyc), "stamps")
                new_b(*a, shift)
                torch.cuda.synchronize()
                check(lib.fz_chi2_stack_stamps(cyc), "stamps")
            chunks = max(1, cyc[6])
            res["stamps"] = {"chunks": cyc[6], "ctas": cyc[7],
                             "cycles_per_chunk": {
                                 part: cyc[i] / chunks
                                 for i, part in enumerate(STAMP_PARTS)}}
            print(f"ab_fullmask B={B} stamps (band order): "
                  f"{json.dumps(res['stamps'])} | card {card}", flush=True)
        print(f"ab_fullmask B={B}: shapes {json.dumps(res['shapes'])}, "
              f"issue floors {json.dumps(res['issue_floor_ms'])} ms | card "
              f"{card}", flush=True)
        report["sizes"][str(B)] = res
        del d, de
        torch.cuda.empty_cache()
    del orders
    torch.cuda.empty_cache()
    # The run-time instantiations (the log form), in band order.
    orders = model_orders(models_log)
    report["log_form"] = {"filters": F_LOG, "sizes": {}}
    for B in SIZES:
        d = torch.tensor(data_log[:B], device=dev)
        res = case(d, torch.full_like(d, 0.25), *orders["band"])
        ok = ok and res["ok"]
        show(f"F={F_LOG} (log form) B={B} band order", res)
        report["log_form"]["sizes"][str(B)] = res
        del d
    del orders, G
    torch.cuda.empty_cache()
    if not args.no_walls:
        tree, here = Path(args.ref_tree).resolve(), Path.cwd()
        walls = {"ref": [], "package": []}
        for who in ("ref", "package", "package", "ref"):
            walls[who].append(_walls(tree if who == "ref" else here))
        digests = sorted({r["sha256"] for runs in walls.values()
                          for r in runs})
        report["screen_false_walls"] = walls
        report["screen_false_s"] = {
            who: statistics.median(w for r in runs for w in r["walls"])
            for who, runs in walls.items()}
        report["screen_false_sha256"] = digests
        ok = ok and len(digests) == 1
        print(f"ab_fullmask fused_fit_pdf(screen=False), two {N_E2E // 2}"
              f"-object batches (median walls, s): "
              f"{report['screen_false_s']}, SHA-256 {digests} | card "
              f"{card}", flush=True)
    report["ok"] = ok
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    line = json.dumps(report)
    (out_dir / "ab_fullmask.json").write_text(line + "\n")
    print(line, flush=True)
    if not ok:
        raise SystemExit("a check failed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
