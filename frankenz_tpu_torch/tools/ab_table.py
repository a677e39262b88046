"""The table route's producers and its band reader against other builds
of them, in turns.

    python -m frankenz_tpu_torch.tools.ab_table [--out DIR] [--reps N]
        [--variants sweeps_rows4 store_rows16 ...] [--stamps]
        [--ref-tree DIR [--no-walls]]

Run from the root of a checkout on a machine with a CUDA card and
`nvcc`.  Two kernels write the lnl table of the two-pass threshold route
(`kernels.general`):
- `scale_sweeps` on config 8's batch (bench.py:612-699: 16,384 copies of
  100,000 models x 5 filters from ``default_rng(0)``, scaled by U(0.5, 2)
  plus N(0, 0.3) noise, data errors 0.25, model errors 5%, full masks;
  group width 512, ltol 1e-4, max_iter 100).  Variants compile
  ``csrc/lnl_freescale.cu``: ``sweeps_rowsN`` (-DFZ_WROWS=N objects a
  block), ``sweeps_threadsN`` (-DFZ_WTHREADS=N threads a block);
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
sweep table, lmap, levid and the lnl table, or the band reader's PDF)
equal to the package's bit for bit, and reports its registers and spills
(`nvcc -Xptxas -v`) and, for `scale_sweeps`, the blocks an SM holds.
With ``--stamps`` it also builds ``csrc/lnl_freescale.cu`` and
``csrc/lnl_table.cu`` with -DFZ_STAMPS (debug builds: each block's
thread 0 adds the clock64 cycles of each part of `scale_sweeps`, and of a
tile of `lnl_stack_read` on the masked chunk's table and of
`lnl_stack_band` on its band-order table, to a device array) and prints
the cycles a block sweep or a tile of each part, and the package's reader
times there.

With ``--ref-tree DIR`` (an earlier commit's `frankenz_tpu_torch/`, e.g.
``git archive <commit> frankenz_tpu_torch | tar -x -C build/ab/ref``,
whose ``csrc/lnl_table.cu`` exports `fz_lnl_stack_read`) it also times that tree's `lnl_stack_read` on the caller-order
table against the package's `lnl_stack_band` on the band-order table, in
turns, and (unless ``--no-walls``) `BruteForce.fit_predict` over the
131,072 masked objects under wt_thresh 1e-3 in each tree, each in its own
process, in turns (earlier, package, package, earlier; a warm-up and 3
walls a process), with a SHA-256 of each run's PDFs, lmap and levid: one
digest a tree (the band order sums levid and the PDFs in another order,
so the trees' digests may differ).  It prints one JSON line and writes it
to ``DIR/ab_table.json``.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

from .ab_band import _walls

NMODEL, NFILT, N8, TM, LTOL, MAX_ITER = 100_000, 5, 16_384, 512, 1e-4, 100
NCHUNK, N_E2E, NGRID = 32_768, 131_072, 301
VARIANTS = {
    "sweeps_rows2": ("lnl_freescale.cu", ["-DFZ_WROWS=2"]),
    "sweeps_rows4": ("lnl_freescale.cu", ["-DFZ_WROWS=4"]),
    "sweeps_rows16": ("lnl_freescale.cu", ["-DFZ_WROWS=16"]),
    "sweeps_threads128": ("lnl_freescale.cu", ["-DFZ_WTHREADS=128"]),
    "sweeps_threads512": ("lnl_freescale.cu", ["-DFZ_WTHREADS=512"]),
    "store_rows16": ("lnl_general.cu", ["-DFZ_PROWS=16", "-DFZ_PTHREADS=128"]),
    "store_rows64": ("lnl_general.cu", ["-DFZ_PROWS=64"]),
    "store_threads128": ("lnl_general.cu", ["-DFZ_PTHREADS=128"]),
    "store_threads512": ("lnl_general.cu", ["-DFZ_PTHREADS=512"]),
    "store_rows32": ("lnl_general.cu", ["-DFZ_PROWS=32"]),
    "store_rows128": ("lnl_general.cu", ["-DFZ_PROWS=128"]),
    "store_rows64_threads128": ("lnl_general.cu", ["-DFZ_PROWS=64",
                                                   "-DFZ_PTHREADS=128"]),
    "sweeps_rows1": ("lnl_freescale.cu", ["-DFZ_WROWS=1"]),
    "sweeps_rows8": ("lnl_freescale.cu", ["-DFZ_WROWS=8"]),
}
KINDS = {"lnl_freescale.cu": "sweeps", "lnl_general.cu": "store",
         "lnl_table.cu": "band"}
STACK_PARTS = ("table wait and barrier", "weights", "barrier and mask",
               "G copies and wait", "products")
PARTS = ("staging and sweep 0", "pair updates", "warp maxima and barrier",
         "freeze and barriers", "table pass")


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "nvidia-smi unavailable"


def _compile(build, name, source, flags):
    """Start nvcc (-Xptxas -v) on `source` with `flags` into its own
    library; returns (process, library path)."""
    out = build.library_path().parent / f"libfz_ab_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.nvcc_path(), *build._NVCC_FLAGS, *flags, "-Xptxas", "-v",
           "-I", str(build._SRC_DIR), "-shared", "-o", str(out),
           str(build._SRC_DIR / source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def _bind(path):
    lib = ctypes.CDLL(str(path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, argtypes in (
            ("fz_scale_sweeps", [P] * 9 + [I] * 8 + [F, I, F, P]),
            ("fz_scale_sweeps_occupancy", [I] * 4),
            ("fz_scale_sweeps_stamps", [P]),
            ("fz_lnl_reduce_store", [P] * 10 + [I] * 7 + [F, P]),
            ("fz_lnl_stack_read", [P, I] + [P] * 4 + [I] * 3 + [F, I, P]),
            ("fz_lnl_stack_band", [P, I, P, I, P, I] + [P] * 3 + [I] * 3
             + [F, P]),
            ("fz_lnl_stack_read_stamps", [P])):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = I
    return lib


def _ptxas(build, text, kernel):
    """Registers and spills of the config's instantiation of `kernel`
    (the band reader: both stack readers the build holds, by name)."""
    found = build.parse_ptxas(text)
    if kernel == "band":
        return {k: v for k, v in found.items() if "lnl_stack_" in k}
    key = {"sweeps": ("scale_sweeps_kernel", "ILb1ELb1ELb1E"),
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/ab_table")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--stamps", action="store_true")
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
    builds["package_sweeps"] = ("lnl_freescale.cu", [])
    builds["package_store"] = ("lnl_general.cu", [])
    builds["package_band"] = ("lnl_table.cu", [])
    if args.stamps:
        builds["stamps"] = ("lnl_freescale.cu", ["-DFZ_STAMPS"])
        builds["stack_stamps"] = ("lnl_table.cu", ["-DFZ_STAMPS"])
    procs = {name: _compile(build, name, *spec)
             for name, spec in builds.items()}
    ref_proc = None
    if args.ref_tree:
        ref_src = Path(args.ref_tree) / "frankenz_tpu_torch" / "csrc"
        ref_out = build.library_path().parent / "libfz_ab_ref_table.so"
        ref_proc = subprocess.Popen(
            [build.nvcc_path(), *build._NVCC_FLAGS, "-I", str(ref_src),
             "-shared", "-o", str(ref_out), str(ref_src / "lnl_table.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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
        sw, tab = out
        check(lib.fz_scale_sweeps(
            *[t.data_ptr() for t in args8], gl.data_ptr(), sw.data_ptr(),
            tab.data_ptr(), width, N8, NMODEL, NFILT, TM, ng, 1, 1, LTOL,
            MAX_ITER, nd_full, stream()), "scale_sweeps")

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
        return all(torch.equal(x[..., :NMODEL], y[..., :NMODEL])
                   for x, y in zip(a, b))

    def outputs(kind):
        if kind == "sweeps":
            return (torch.empty((N8, ng), dtype=torch.int16, device=dev),
                    torch.empty((N8, width), device=dev))
        if kind == "band":
            return (torch.empty((NCHUNK, NGRID), device=dev),)
        return (torch.empty(NCHUNK, device=dev),
                torch.empty(NCHUNK, device=dev),
                torch.empty((NCHUNK, width), device=dev))

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
                      NFILT, TM, 1, 1)},
              "variants": {}}
    for name in args.variants:
        kind = KINDS[VARIANTS[name][0]]
        fn, lib = fns[kind], _bind(procs[name][1])
        got = outputs(kind)
        fn(lib, got)
        torch.cuda.synchronize()
        same = equal(got, want[kind])
        old, new = [], []
        for _ in range(args.reps):
            old.append(timed(fn, pkg, got))
            new.append(timed(fn, lib, got))
            new.append(timed(fn, lib, got))
            old.append(timed(fn, pkg, got))
        v = {"flags": builds[name][1], "equal": same,
             "package_ms": statistics.median(old),
             "variant_ms": statistics.median(new), "ptxas": ptxas[name]}
        if kind == "sweeps":
            v["blocks_per_sm"] = lib.fz_scale_sweeps_occupancy(NFILT, TM, 1,
                                                               1)
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
        nsweeps, nblocks = max(1, cyc[5]), max(1, cyc[6])
        report["stamps"] = {
            "block_sweeps": cyc[5], "blocks": cyc[6],
            "cycles_per_block_sweep": {
                part: cyc[i] / nsweeps for i, part in enumerate(PARTS)
                if i in (1, 2, 3)},
            "cycles_per_block": {part: cyc[i] / nblocks
                                 for i, part in enumerate(PARTS)
                                 if i in (0, 4)}}
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
    if args.ref_tree:
        # The earlier tree's caller-order reader against the package's
        # band reader on the same chunk, in turns.
        ref = _bind(ref_out)
        got = outputs("band")
        old, new = [], []
        for _ in range(args.reps):
            old.append(timed(stack, ref, None))
            new.append(timed(band, pkg, got))
            new.append(timed(band, pkg, got))
            old.append(timed(stack, ref, None))
        err = float(((got[0] - pdf).abs().amax(dim=1)
                     / pdf.abs().amax(dim=1).clamp_min(1e-30)).max())
        report["ref_reader"] = {
            "ref_tree": str(Path(args.ref_tree).resolve()),
            "ref_lnl_stack_read_ms": statistics.median(old),
            "package_lnl_stack_band_ms": statistics.median(new),
            "pdf_row_normwise_diff": err}
        print(f"ab_table earlier tree's lnl_stack_read (caller order) "
              f"{report['ref_reader']['ref_lnl_stack_read_ms']:.3f} ms, "
              f"package lnl_stack_band "
              f"{report['ref_reader']['package_lnl_stack_band_ms']:.3f} ms "
              f"over {NCHUNK} rows, PDFs row-normwise {err:.3g} apart | card "
              f"{card}", flush=True)
        del got
    print(f"ab_table package: {report['package']}, mean sweeps "
          f"{report['mean_sweeps']:.4f} | card {card}", flush=True)
    del args4, args8, mods, tab_b, bs, want, pdf
    torch.cuda.empty_cache()
    if args.ref_tree and not args.no_walls:
        tree, here = Path(args.ref_tree).resolve(), Path.cwd()
        walls = {"ref": [], "package": []}
        for who in ("ref", "package", "package", "ref"):
            walls[who].append(_walls(tree if who == "ref" else here, who,
                                     ("table",)))
        digests = {who: sorted({r["sha256"]["table"] for r in runs})
                   for who, runs in walls.items()}
        report["fit_predict_131072_table"] = {
            who: statistics.median(w for r in runs for w in
                                   r["walls"]["table"])
            for who, runs in walls.items()}
        report["fit_predict_walls"] = walls
        report["fit_predict_sha256"] = digests
        print(f"ab_table fit_predict {N_E2E} masked, wt_thresh 1e-3 (median "
              f"walls, s): {report['fit_predict_131072_table']}, SHA-256 "
              f"{digests} | card {card}", flush=True)
        if any(len(d) != 1 for d in digests.values()):
            raise SystemExit("a tree's fit_predict outputs differ run to run")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    line = json.dumps(report)
    (out_dir / "ab_table.json").write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
