"""The table route's producers and its band reader against other builds
of them, in turns.

    python -m frankenz_tpu_torch.tools.ab_table [--out DIR] [--reps N]
        [--variants sweeps_norest store_rows16 ...] [--stamps] [--rest]
        [--ref-tree DIR [--no-walls]]

Run from the root of a checkout on a machine with a CUDA card and
`nvcc`.  Two kernels write the lnl table of the two-pass threshold route
(`kernels.general`):
- `scale_sweeps` on config 8's batch (bench.py:612-699: 16,384 copies of
  100,000 models x 5 filters from ``default_rng(0)``, scaled by U(0.5, 2)
  plus N(0, 0.3) noise, data errors 0.25, model errors 5%, full masks;
  group width 512, ltol 1e-4, max_iter 100).  Variants compile
  ``csrc/scale_sweeps.cu``: ``sweeps_warpsN`` (-DFZ_SWEEP_WARPS=N warps
  a block), ``sweeps_rowsN`` (-DFZ_SWEEP_ROWS=N rows a warp);
- `lnl_reduce_store` (fixed scale, masked, dim prior) on one 32,768-row
  chunk of the masked config-4 batch (chip_smoke.py's data: 15% of the
  bands missing).  Variants compile ``csrc/lnl_general.cu``:
  ``store_rowsN`` (-DFZ_PROWS=N rows a block), ``store_threadsN``
  (-DFZ_PTHREADS=N threads a block);
- `lnl_stack_band`, the reader of the same chunk's table written over the
  models in band order (`band_sort` of config 4's G: the producer on the
  sorted model arrays): its registers and spills, and its stamps.
Every build starts at once.  For each variant it times the package's
kernel and the variant in turns (package, variant, variant, package;
CUDA events, median of `--reps` turns), checks the variant's outputs (the
sweep table and the lnl table, lmap and levid, or the band reader's PDF)
equal to the package's bit for bit, and reports its registers and spills
(`nvcc -Xptxas -v`) and, for `scale_sweeps`, the blocks an SM holds and
its warps a block.  With ``--stamps`` it also builds
``csrc/scale_sweeps.cu`` and ``csrc/lnl_table.cu`` with -DFZ_STAMPS
(debug builds: lane 0 of each sweep warp, or thread 0 of each reader
block, adds the clock64 cycles of each part to a device array) and prints
the cycles a warp sweep or a row of each part of `scale_sweeps`, and a
tile of `lnl_stack_read` on the masked chunk's table and of
`lnl_stack_band` on its band-order table, with the package's reader
times there.  With ``--rest`` it builds ``csrc/scale_sweeps.cu`` with
-DFZ_REST and prints, on config 8's batch, the pair-sweeps left out, at
rest and in 2-cycles (`tools/sweep_stats.py`: overall and by sweep
index), the fixed 32-slot chunks whose pairs had all left, the list
iterations run, k per (object, group), the
first design's 2-row blocks that held a frozen row, the SASS
instructions of one list iteration (`cuobjdump -sass`) and the issue
floor they give at the card's maximum SM clock.

With ``--ref-tree DIR`` (an earlier commit's `frankenz_tpu_torch/`, e.g.
``git archive <commit> frankenz_tpu_torch | tar -x -C build/ab/ref``,
whose ``csrc/scale_sweeps.cu``, or before it ``csrc/lnl_freescale.cu``,
exports `fz_scale_sweeps`) it also times that tree's `scale_sweeps` with
an lnl table against the package's on config 8's batch, in turns,
requires both trees' sweep tables and lnl tables equal bit for bit, and
(unless ``--no-walls``) times config 8's `BruteForce.fit_predict` (free
scale with model errors, wt_thresh 1e-3) in each tree, each in its own
process, in turns (earlier, package, package, earlier; a warm-up and 3
walls a process), with a SHA-256 of each run's PDFs, lmap and levid,
which must be one digest for both trees.  It prints one JSON line and
writes it to ``DIR/ab_table.json``.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

from . import sweep_stats as SS

NMODEL, NFILT, N8, TM, LTOL, MAX_ITER = 100_000, 5, 16_384, 512, 1e-4, 100
NCHUNK, N_E2E, NGRID = 32_768, 131_072, 301
VARIANTS = {
    "sweeps_warps8": ("scale_sweeps.cu", ["-DFZ_SWEEP_WARPS=8"]),
    "sweeps_warps4": ("scale_sweeps.cu", ["-DFZ_SWEEP_WARPS=4"]),
    "sweeps_warps16": ("scale_sweeps.cu", ["-DFZ_SWEEP_WARPS=16"]),
    "sweeps_rows4": ("scale_sweeps.cu", ["-DFZ_SWEEP_ROWS=4"]),
    "sweeps_rows32": ("scale_sweeps.cu", ["-DFZ_SWEEP_ROWS=32"]),
    "store_rows16": ("lnl_general.cu", ["-DFZ_PROWS=16", "-DFZ_PTHREADS=128"]),
    "store_rows64": ("lnl_general.cu", ["-DFZ_PROWS=64"]),
    "store_threads128": ("lnl_general.cu", ["-DFZ_PTHREADS=128"]),
    "store_threads512": ("lnl_general.cu", ["-DFZ_PTHREADS=512"]),
    "store_rows32": ("lnl_general.cu", ["-DFZ_PROWS=32"]),
    "store_rows128": ("lnl_general.cu", ["-DFZ_PROWS=128"]),
    "store_rows64_threads128": ("lnl_general.cu", ["-DFZ_PROWS=64",
                                                   "-DFZ_PTHREADS=128"]),
}
KINDS = {"scale_sweeps.cu": "sweeps", "lnl_general.cu": "store",
         "lnl_table.cu": "band"}
STACK_PARTS = ("table wait and barrier", "weights", "barrier and mask",
               "G copies and wait", "products")
PARTS = ("row fetch and staging", "pair updates", "warp maxima and freeze",
         "table pass", "block staging")
# Config 8's walls in one tree (its own process): a warm-up on 2,048 rows,
# then 3 walls of the 16,384-row call, and a SHA-256 of PDFs, lmap, levid.
_WALLS8 = r"""
import hashlib, json, time
import numpy as np, torch
from frankenz_tpu_torch.models import BruteForce
from frankenz_tpu_torch.ops import kde as TK
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
N8, M, F, NG = %d, %d, %d, %d
f32 = np.float32
models = np.random.default_rng(0).uniform(1, 10, (M, F)).astype(f32)
rng8 = np.random.default_rng(0)
rng8.uniform(1, 10, (M, F))
scales = rng8.uniform(0.5, 2.0, (N8, 1))
data8 = (scales * models[rng8.integers(0, M, N8)]
         + rng8.normal(0, 0.3, (N8, F))).astype(f32)
zl8 = rng8.uniform(0, 3.5, M)
pdict = TK.PDFDict(np.linspace(0.0, 4.0, NG), np.linspace(0.01, 0.5, 100))
bf = BruteForce(models, (0.05 * models).astype(f32), np.ones_like(models),
                device="cuda")
de, ones, zerr = np.full((N8, F), 0.25, f32), np.ones((N8, F), f32), np.full(M, 0.1)
kw = dict(label_dict=pdict, verbose=False, return_gof=True,
          lprob_kwargs=dict(free_scale=True, ltol=1e-4))
bf.fit_predict(data8[:2048], de[:2048], ones[:2048], zl8, zerr, **kw)
torch.cuda.synchronize()
walls = []
for _ in range(3):
    t0 = time.perf_counter()
    pdfs, gof = bf.fit_predict(data8, de, ones, zl8, zerr, **kw)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
digest = hashlib.sha256()
for x in (pdfs, gof[0], gof[1]):
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


# The other kernels' entry points (`sweep_stats.bind` types the sweeps').
_ENTRIES = (
    ("fz_lnl_reduce_store", ["P"] * 10 + ["I"] * 7 + ["F", "P"]),
    ("fz_lnl_stack_read", ["P", "I"] + ["P"] * 4 + ["I"] * 3
     + ["F", "I", "P"]),
    ("fz_lnl_stack_band", ["P", "I", "P", "I", "P", "I"] + ["P"] * 3
     + ["I"] * 3 + ["F", "P"]),
    ("fz_lnl_stack_read_stamps", ["P"]))


def _bind(path):
    return SS.bind(path, _ENTRIES)


def _ptxas(build, text, kernel):
    """Registers and spills of the config's instantiation of `kernel`
    (the band reader: both stack readers the build holds, by name)."""
    found = build.parse_ptxas(text)
    if kernel == "band":
        return {k: v for k, v in found.items() if "lnl_stack_" in k}
    key = {"sweeps": ("scale_sweeps_kernel", "ILb1ELb1ELb1ELi5EE"),
           "store": ("lnl_reduce_store_kernel", "FixedPairILb0ELb1ELb0E")}
    name, inst = key[kernel]
    hits = [v for k, v in found.items() if name in k and inst in k]
    return hits[0] if hits else None


def _stack_cycles(cyc):
    """The stack readers' stamps: cycles a tile by part, and a tile with
    products by its last two parts."""
    ntiles, nprod = max(1, cyc[6]), max(1, cyc[5])
    return {"tiles": cyc[6], "tiles_with_products": cyc[5],
            "cycles_per_tile": {part: cyc[i] / ntiles
                                for i, part in enumerate(STACK_PARTS)},
            "cycles_per_tile_with_products": {
                part: cyc[i] / nprod for i, part in enumerate(STACK_PARTS)
                if i >= 3}}


def _walls8(tree, who):
    """Config 8's fit_predict walls and output digest in the tree at
    `tree` (its own process)."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    run = subprocess.run(
        [sys.executable, "-c", _WALLS8 % (N8, NMODEL, NFILT, NGRID)],
        cwd=str(tree), env=env, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"config 8 walls in {tree} ({who}) failed:\n"
                           f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    line = [x for x in run.stdout.splitlines() if x.startswith("WALLS ")]
    return json.loads(line[-1][len("WALLS "):])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/ab_table")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--rest", action="store_true")
    ap.add_argument("--ref-tree", default=None)
    ap.add_argument("--no-walls", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..kernels import build
    from ..kernels import general as GK
    from ..ops import kde

    if not torch.cuda.is_available():
        raise SystemExit("ab_table needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    dev = torch.device("cuda")
    builds = {name: VARIANTS[name] for name in args.variants}
    builds["package_sweeps"] = ("scale_sweeps.cu", [])
    builds["package_store"] = ("lnl_general.cu", [])
    builds["package_band"] = ("lnl_table.cu", [])
    if args.stamps:
        builds["stamps"] = ("scale_sweeps.cu", ["-DFZ_STAMPS"])
        builds["stack_stamps"] = ("lnl_table.cu", ["-DFZ_STAMPS"])
    if args.rest:
        builds["rest"] = ("scale_sweeps.cu", ["-DFZ_REST"])
    procs = {name: SS.start(build, name, flags, build._SRC_DIR / source)
             for name, (source, flags) in builds.items()}
    ref_proc = None
    if args.ref_tree:
        # The earlier tree's scale_sweeps: its own source from this design
        # on, lnl_freescale.cu before it.
        ref_src = Path(args.ref_tree) / "frankenz_tpu_torch" / "csrc"
        src = ref_src / "scale_sweeps.cu"
        if not src.exists():
            src = ref_src / "lnl_freescale.cu"
        ref_proc, ref_out = SS.start(build, "ref_sweeps", [], src)
    build.build()
    pkg = build.load()
    ptxas = {}
    for name, (proc, _) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        ptxas[name] = _ptxas(build, out, KINDS[builds[name][0]])
    if ref_proc is not None:
        out = ref_proc.communicate()[0]
        if ref_proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier tree:\n{out}")
        found = build.parse_ptxas(out)
        ptxas["ref_sweeps"] = [v for k, v in found.items()
                               if "scale_sweeps_kernel" in k
                               and "ILb1ELb1ELb1E" in k]

    f32 = np.float32
    rng = np.random.default_rng(0)
    models = rng.uniform(1, 10, (NMODEL, NFILT)).astype(f32)
    zl = rng.uniform(0, 3.5, NMODEL)  # chip_smoke.py's labels
    data4 = rng.uniform(1, 10, (N_E2E, NFILT)).astype(f32)[:NCHUNK]
    dmask = (np.random.default_rng(2).uniform(size=(N_E2E, NFILT))
             >= 0.15).astype(f32)[:NCHUNK]
    rng8 = np.random.default_rng(0)
    rng8.uniform(1, 10, (NMODEL, NFILT))
    scales = rng8.uniform(0.5, 2.0, (N8, 1))
    data8 = (scales * models[rng8.integers(0, NMODEL, N8)]
             + rng8.normal(0, 0.3, (N8, NFILT))).astype(f32)

    def tens(x):
        return torch.tensor(np.ascontiguousarray(x), device=dev)

    mods = [tens(models.T), tens((0.05 * models).astype(f32).T),
            tens(np.ones((NFILT, NMODEL), f32))]
    args8 = [tens(data8), tens(np.full((N8, NFILT), 0.25, f32)),
             tens(np.ones((N8, NFILT), f32))] + mods
    args4 = [tens(data4), tens(np.full((NCHUNK, NFILT), 0.25, f32)),
             tens(dmask)] + mods
    ng = -(-NMODEL // TM)
    width = GK.table_width(NMODEL)
    gl = GK.gl_table(NFILT, dev)
    nd_full = float(np.float32(NFILT * 1.8378770664093453))
    # Config 4's G (chip_smoke.py's PDFDict) and the chunk's lnl table over
    # the models in band order, from the package's producer.
    pdict = kde.PDFDict(np.linspace(0.0, 4.0, NGRID),
                        np.linspace(0.01, 0.5, 100))
    G = kde.kernel_matrix_dict(pdict, *pdict.fit(zl, np.full(NMODEL, 0.1)),
                               device=dev).to(torch.float32).contiguous()
    bs = GK.band_sort(G, *mods)
    tab_b = torch.empty((NCHUNK, width), device=dev)
    lm_b, lv_b = GK.lnl_reduce(*args4[:3], bs.mT, bs.meT, bs.mmT,
                               table=tab_b)
    thr = float(np.float32(np.log(1e-3)))
    threads = GK._col_threads(NGRID)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {rc}")

    def sweeps(lib, out):
        SS.launch(lib, args8, *out, tm=TM, full_mask=True, dim_prior=True,
                  ltol=LTOL, max_iter=MAX_ITER)

    def store(lib, out):
        lm, lv, tab = out
        check(lib.fz_lnl_reduce_store(
            *[t.data_ptr() for t in args4], gl.data_ptr(), lm.data_ptr(),
            lv.data_ptr(), tab.data_ptr(), width, NCHUNK, NMODEL, NFILT, 0,
            1, 0, nd_full, stream()), "lnl_reduce_store")

    def band(lib, out):
        check(lib.fz_lnl_stack_band(
            tab_b.data_ptr(), width, bs.G.data_ptr(), bs.G.shape[1],
            bs.bands.data_ptr(), int(bs.width), lm_b.data_ptr(),
            lv_b.data_ptr(), out[0].data_ptr(), NCHUNK, NMODEL, NGRID, thr,
            stream()), "lnl_stack_band")

    def timed(fn, lib, out):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(lib, out)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1)

    def equal(a, b):
        """Two builds' outputs equal in every bit over the first NMODEL
        columns (NaN payloads too)."""
        bits = {torch.float32: torch.int32}
        return all(torch.equal(*(t[..., :NMODEL].view(bits.get(t.dtype,
                                                               t.dtype))
                                 for t in (x, y))) for x, y in zip(a, b))

    def outputs(kind):
        if kind == "sweeps":
            return (torch.empty((N8, ng), dtype=torch.int16, device=dev),
                    torch.full((N8, width), float("nan"), device=dev))
        if kind == "band":
            return (torch.empty((NCHUNK, NGRID), device=dev),)
        return (torch.empty(NCHUNK, device=dev),
                torch.empty(NCHUNK, device=dev),
                torch.empty((NCHUNK, width), device=dev))

    def turns(fn, old_lib, new_lib, got, reps):
        old, new = [], []
        for _ in range(reps):
            old.append(timed(fn, old_lib, got))
            new.append(timed(fn, new_lib, got))
            new.append(timed(fn, new_lib, got))
            old.append(timed(fn, old_lib, got))
        return statistics.median(old), statistics.median(new)

    fns = {"sweeps": sweeps, "store": store, "band": band}
    want = {kind: outputs(kind) for kind in fns}
    for kind, fn in fns.items():
        fn(pkg, want[kind])
    torch.cuda.synchronize()
    report = {"card": card, "config8_batch": N8, "masked_chunk": NCHUNK,
              "models": NMODEL, "tm": TM,
              "mean_sweeps": float(want["sweeps"][0].float().mean()),
              "band_cols_mean": float((bs.bands[:, 1] - bs.bands[:, 0])
                                      .float().mean()),
              "package": {
                  "sweeps_ptxas": ptxas["package_sweeps"],
                  "store_ptxas": ptxas["package_store"],
                  "band_ptxas": ptxas["package_band"],
                  "sweeps_blocks_per_sm": pkg.fz_scale_sweeps_occupancy(
                      NFILT, TM, 1, 1),
                  "sweeps_warps_per_block": pkg.fz_scale_sweeps_warps(
                      NFILT, TM, 1, 1)},
              "variants": {}}
    for name in args.variants:
        kind = KINDS[VARIANTS[name][0]]
        fn, lib = fns[kind], _bind(procs[name][1])
        got = outputs(kind)
        fn(lib, got)
        torch.cuda.synchronize()
        same = equal(got, want[kind])
        pkg_ms, var_ms = turns(fn, pkg, lib, got, args.reps)
        v = {"flags": builds[name][1], "equal": same, "package_ms": pkg_ms,
             "variant_ms": var_ms, "ptxas": ptxas[name]}
        if kind == "sweeps":
            v["blocks_per_sm"] = lib.fz_scale_sweeps_occupancy(NFILT, TM, 1,
                                                               1)
            v["warps_per_block"] = lib.fz_scale_sweeps_warps(NFILT, TM, 1, 1)
        report["variants"][name] = v
        del got
        print(f"ab_table {name} {v['flags']}: package {v['package_ms']:.3f}"
              f" ms, variant {v['variant_ms']:.3f} ms, bit-equal {same}, "
              f"{v.get('blocks_per_sm', '-')} blocks an SM, ptxas "
              f"{v['ptxas']} | card {card}", flush=True)
    lm, lv, tab = want["store"]
    pdf = torch.empty((NCHUNK, NGRID), device=dev)

    def stack(lib, _):
        check(lib.fz_lnl_stack_read(
            tab.data_ptr(), width, G.data_ptr(), lm.data_ptr(),
            lv.data_ptr(), pdf.data_ptr(), NCHUNK, NMODEL, NGRID, thr,
            threads, stream()), "lnl_stack_read")

    if args.stamps:
        lib = _bind(procs["stamps"][1])
        cyc = (ctypes.c_ulonglong * 8)()
        check(lib.fz_scale_sweeps_stamps(cyc), "stamps")
        sweeps(lib, outputs("sweeps"))
        torch.cuda.synchronize()
        check(lib.fz_scale_sweeps_stamps(cyc), "stamps")
        nsweeps, nrows, nblocks = (max(1, cyc[i]) for i in (5, 6, 7))
        report["stamps"] = {
            "warp_sweeps": cyc[5], "warp_rows": cyc[6], "blocks": cyc[7],
            "cycles_per_warp_sweep": {PARTS[i]: cyc[i] / nsweeps
                                      for i in (1, 2)},
            "cycles_per_warp_row": {PARTS[i]: cyc[i] / nrows
                                    for i in (0, 1, 2, 3)},
            "cycles_per_block": {PARTS[4]: cyc[4] / nblocks}}
        print(f"ab_table stamps: {report['stamps']} | card {card}",
              flush=True)
        # The readers on the masked chunk's tables: the caller-order
        # reader and the band reader.
        lib = _bind(procs["stack_stamps"][1])
        for key, fn in (("stack", stack), ("band", band)):
            check(lib.fz_lnl_stack_read_stamps(cyc), "stamps")
            fn(lib, outputs("band"))
            torch.cuda.synchronize()
            check(lib.fz_lnl_stack_read_stamps(cyc), "stamps")
            report[key] = dict(_stack_cycles(cyc),
                               stamps_ms=timed(fn, lib, outputs("band")),
                               ptxas=ptxas["stack_stamps"],
                               package_ms=statistics.median(
                                   timed(fn, pkg, outputs("band"))
                                   for _ in range(2 * args.reps)))
            print(f"ab_table {key} (masked chunk): {report[key]} | card "
                  f"{card}", flush=True)
    if args.rest:
        lib = _bind(procs["rest"][1])
        got = outputs("sweeps")

        def run():
            sweeps(lib, got)
            torch.cuda.synchronize()

        st, sass, _ = SS.report(build, lib, run)
        st["counting_build_equal"] = equal(got, want["sweeps"])
        st["first_design_2row_blocks"] = SS.pair_waits(want["sweeps"][0])
        st["sass"] = sass
        report["rest"] = st
        del got
        print(f"ab_table rest (config 8's {N8} rows): " + json.dumps(
            {k: v for k, v in st.items()
             if k not in ("k_hist", "rest_share_by_sweep",
                          "cycle_share_by_sweep")})
            + f" | card {card}", flush=True)
    if args.ref_tree:
        # The earlier tree's scale_sweeps against the package's on config
        # 8's batch with an lnl table, in turns; both tables bit for bit.
        ref = _bind(ref_out)
        got = outputs("sweeps")
        sweeps(ref, got)
        torch.cuda.synchronize()
        same = equal(got, want["sweeps"])
        ref_ms, pkg_ms = turns(sweeps, ref, pkg, got, args.reps)
        report["ref_sweeps"] = {
            "ref_tree": str(Path(args.ref_tree).resolve()),
            "ref_source": src.name, "ref_ptxas": ptxas["ref_sweeps"],
            "ref_ms": ref_ms, "package_ms": pkg_ms,
            "tables_equal": same}
        print(f"ab_table earlier tree's scale_sweeps ({src.name}) "
              f"{ref_ms:.3f} ms, package {pkg_ms:.3f} ms over config 8's "
              f"{N8} rows with an lnl table, sweep and lnl tables bit-equal "
              f"{same} | card {card}", flush=True)
        del got
        if not same:
            raise SystemExit("the trees' sweep or lnl tables differ")
    print(f"ab_table package: {report['package']}, mean sweeps "
          f"{report['mean_sweeps']:.4f} | card {card}", flush=True)
    del args4, args8, mods, tab_b, bs, want, pdf
    torch.cuda.empty_cache()
    if args.ref_tree and not args.no_walls:
        tree, here = Path(args.ref_tree).resolve(), Path.cwd()
        walls = {"ref": [], "package": []}
        for who in ("ref", "package", "package", "ref"):
            walls[who].append(_walls8(tree if who == "ref" else here, who))
        digests = sorted({r["sha256"] for runs in walls.values()
                          for r in runs})
        report["fit_predict_config8"] = {
            who: statistics.median(w for r in runs for w in r["walls"])
            for who, runs in walls.items()}
        report["fit_predict_walls"] = walls
        report["fit_predict_sha256"] = digests
        print(f"ab_table config 8 fit_predict, {N8} objects (median walls, "
              f"s): {report['fit_predict_config8']}, SHA-256 {digests} | "
              f"card {card}", flush=True)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    line = json.dumps(report)
    (out_dir / "ab_table.json").write_text(line + "\n")
    print(line, flush=True)
    if args.ref_tree and not args.no_walls and len(digests) != 1:
        raise SystemExit("config 8's fit_predict outputs differ between "
                         "runs or trees")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
