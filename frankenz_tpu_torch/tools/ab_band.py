"""The band stacks (`lnl_onepass`, `lnl_cut_stack`) against an earlier
tree's dense kernels, or (``--topk``) `lnl_reduce_topk` against an
earlier tree's `lnl_reduce` + `lnl_topk`, in turns.

    python -m frankenz_tpu_torch.tools.ab_band --ref-tree DIR [--out DIR]
        [--reps N] [--no-walls] [--stamps | --topk]

Run from the root of a checkout on a machine with a CUDA card and
`nvcc`.  DIR holds an earlier commit's `frankenz_tpu_torch/` (e.g.
``git archive <commit> frankenz_tpu_torch | tar -x -C build/ab/ref``),
whose ``csrc/lnl_general.cu`` and ``csrc/lnl_freescale.cu`` export the
dense `fz_lnl_onepass` / `fz_lnl_cut_stack` (caller order, one thread a
grid column).  Both sources are built into their own library beside the
package's.  On chip_smoke.py's data (config 4, bench.py:316-332: 100,000
models x 5 filters, a 301-point PDFDict grid, ``default_rng(0)``; 15% of
the data bands missing from ``default_rng(2)``) it times, CUDA events,
the earlier kernel and the package's in turns (earlier, package, package,
earlier; median of `--reps` turns):
- `lnl_onepass` and `lnl_cut_stack` over the masked 65,536-object batch
  (the cut from the package's `lnl_reduce_topk` and `cdf_cut` at
  cdf_thresh 2e-4), each pair's PDFs compared row-normwise;
- `lnl_onepass_fs` over config 8's 16,384-object batch (bench.py:612-699:
  free scale with model errors, full masks; the sweep table from
  `scale_sweeps` at group width 512);
- `band_sort` of config 4's G and the band kernels' registers, spills and
  blocks an SM beside the earlier kernels';
- as a yardstick of the product alone, `torch.matmul` with TF32 off of a
  dense (32,768 x 100,000) float32 weight chunk by G.
Unless ``--no-walls``, it then times `BruteForce.fit_predict` over
131,072 masked objects in the one-pass mode (no threshold), in the cdf
mode (cdf_thresh 2e-4) and in the default mode (wt_thresh 1e-3: the lnl
table route, whose chunks follow the free device memory), each tree in its own process, in turns (earlier,
package, package, earlier), each process one warm-up and the median of 3
walls.  With ``--stamps`` it also builds ``csrc/lnl_general.cu`` with
-DFZ_STAMPS (a debug build: each block's thread 0 adds the clock64
cycles of each part of a tile to a device array) and prints, for both
fixed-scale band kernels over the masked batch, the cycles a tile of the
copy wait and barriers, the weights, the products, and a block's prologue
and epilogue.  It prints one JSON line and writes it to
``DIR/ab_band.json`` (`--out`).

With ``--topk`` the earlier tree's sources export `fz_lnl_reduce` and
`fz_lnl_topk` (the cdf mode's two walks over the models, before they
became one kernel).  On the same data it times the earlier pair and the
package's `lnl_reduce_topk` in turns, T = 8, and checks lmap, levid, the
top-T values and counts bit for bit:
- fixed scale, masked, the dim prior: the 65,536-object batch and its
  first 2,048 rows;
- free scale without model errors, the same rows;
- free scale with model errors on config 8's first 2,048 rows, the sweep
  table from `scale_sweeps` at group width 512.
It reports both trees' registers and spills, then (unless
``--no-walls``) times the cdf mode's walls alone, as above, and checks
that both trees' PDFs, lmap and levid are equal bit for bit (SHA-256 of
the arrays); the JSON line goes to ``DIR/ab_topk.json``.
"""

import argparse
import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

NMODEL, NFILT, NGRID, BATCH, N_E2E, N8 = 100_000, 5, 301, 65_536, 131_072, \
    16_384
TM, CDF_THRESH, CHUNK, N_SMALL, T = 512, 2e-4, 32_768, 2_048, 8
MODES = ("onepass", "cdf", "table")

# One process of the wall comparison: it imports whichever
# `frankenz_tpu_torch` its working directory holds.
_WALLS = r"""
import hashlib, json, time
import numpy as np, torch
from frankenz_tpu_torch.models import BruteForce
from frankenz_tpu_torch.ops import kde as TK
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
N, M, F, NG = %d, %d, %d, %d
f32 = np.float32
rng = np.random.default_rng(0)
models = rng.uniform(1, 10, (M, F)).astype(f32)
zl = rng.uniform(0, 3.5, M)
data = rng.uniform(1, 10, (N, F)).astype(f32)
dmask = (np.random.default_rng(2).uniform(size=(N, F)) >= 0.15).astype(f32)
pdict = TK.PDFDict(np.linspace(0.0, 4.0, NG), np.linspace(0.01, 0.5, 100))
bf = BruteForce(models, (0.05 * models).astype(f32), np.ones_like(models),
                device="cuda")
de = np.full((N, F), 0.25, f32)
zerr = np.full(M, 0.1)
out = {"walls": {}, "sha256": {}}
modes = {"onepass": dict(wt_thresh=None, cdf_thresh=None),
         "cdf": dict(wt_thresh=None, cdf_thresh=%r),
         "table": dict(wt_thresh=1e-3)}
for mode in %r:
    kw = dict(modes[mode], label_dict=pdict, verbose=False, return_gof=True)
    bf.fit_predict(data[:4096], de[:4096], dmask[:4096], zl, zerr, **kw)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        pdfs, gof = bf.fit_predict(data, de, dmask, zl, zerr, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    digest = hashlib.sha256()
    for x in (pdfs, gof[0], gof[1]):
        digest.update(np.ascontiguousarray(x).tobytes())
    out["walls"][mode] = walls
    out["sha256"][mode] = digest.hexdigest()
out["cdf_reruns"] = getattr(bf, "cdf_reruns", None)
print("WALLS " + json.dumps(out), flush=True)
"""


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "nvidia-smi unavailable"


def _start_nvcc(build, csrc, out, sources):
    """Start nvcc (-Xptxas -v) on `sources` of `csrc`, one process each;
    returns [(process, object path)]."""
    out.mkdir(parents=True, exist_ok=True)
    return [(subprocess.Popen(
        [build.nvcc_path(), *build._NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(csrc), "-c", "-o", str(out / (src + ".o")), str(csrc / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        str(out / (src + ".o"))) for src in sources]


def _finish_nvcc(build, procs, lib=None):
    """Wait for `_start_nvcc`'s processes and, given a path, link their
    objects into that library; returns their ptxas text."""
    text = ""
    for p, _ in procs:
        text += p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{text}")
    if lib is not None:
        subprocess.run([build.nvcc_path(), "-shared", "-o", str(lib),
                        *(o for _, o in procs)], check=True)
    return text


def _bind_ref(path, topk):
    """The earlier tree's dense band-stack entry points, or with `topk` its
    `fz_lnl_reduce` and `fz_lnl_topk`."""
    lib = ctypes.CDLL(str(path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if topk:
        sigs = {"fz_lnl_reduce": [P] * 9 + [I] * 6 + [F, P, I, I, P],
                "fz_lnl_topk": [P] * 9 + [I] * 7 + [F, P, I, I, P]}
    else:
        sigs = {"fz_lnl_onepass": [P] * 11 + [I] * 7 + [F, P, I, I, I, P],
                "fz_lnl_cut_stack": [P] * 13 + [I] * 7 + [F, P, I, I, I, P]}
    for name, argtypes in sigs.items():
        for suffix in ("", "_fs"):
            getattr(lib, name + suffix).argtypes = argtypes
            getattr(lib, name + suffix).restype = I
    return lib


STAMP_PARTS = ("copy wait and barriers", "weights", "products",
               "prologue and epilogue")


def _bind_band(path):
    """The band kernels' entry points of another build of lnl_general.cu,
    with the package's signatures (kernels/build.py), and its stamps."""
    lib = ctypes.CDLL(str(path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [F, P, I, I, P]
    lib.fz_lnl_onepass.argtypes = [P] * 13 + [I] * 9 + tail
    lib.fz_lnl_cut_stack.argtypes = [P] * 16 + [I] * 9 + tail
    for name in ("fz_lnl_onepass", "fz_lnl_cut_stack"):
        getattr(lib, name).restype = I
    if hasattr(lib, "fz_lnl_band_stamps"):
        lib.fz_lnl_band_stamps.argtypes = [P]
        lib.fz_lnl_band_stamps.restype = I
    return lib


def _with_lib(build, lib, call):
    """`call()` with the package's wrappers launching from `lib`."""
    load = build.load
    build.load = lambda: lib
    try:
        return call()
    finally:
        build.load = load


def _walls(tree, reps_note, modes):
    """fit_predict walls and output digests of the tree at `tree` in
    `modes` (its own process)."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    run = subprocess.run(
        [sys.executable, "-c", _WALLS % (N_E2E, NMODEL, NFILT, NGRID,
                                         CDF_THRESH, tuple(modes))],
        cwd=str(tree), env=env, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"walls in {tree} ({reps_note}) failed:\n"
                           f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    line = [x for x in run.stdout.splitlines() if x.startswith("WALLS ")]
    return json.loads(line[-1][len("WALLS "):])


def _inputs(np, torch, GK, dev):
    """chip_smoke.py's data on the card: config 4's masked 65,536-object
    batch and config 8's 16,384 rows as (data, err, mask, mT, meT, mmT)
    argument lists, the two label sets, the Gauss-Legendre table and the
    full-mask normalization: (args4, args8, zl, zl8, gl, nd_full)."""
    f32 = np.float32
    rng = np.random.default_rng(0)
    models = rng.uniform(1, 10, (NMODEL, NFILT)).astype(f32)
    zl = rng.uniform(0, 3.5, NMODEL)
    data = rng.uniform(1, 10, (N_E2E, NFILT)).astype(f32)[:BATCH]
    dmask = (np.random.default_rng(2).uniform(size=(N_E2E, NFILT))
             >= 0.15).astype(f32)[:BATCH]
    rng8 = np.random.default_rng(0)
    rng8.uniform(1, 10, (NMODEL, NFILT))
    scales = rng8.uniform(0.5, 2.0, (N8, 1))
    data8 = (scales * models[rng8.integers(0, NMODEL, N8)]
             + rng8.normal(0, 0.3, (N8, NFILT))).astype(f32)
    zl8 = rng8.uniform(0, 3.5, NMODEL)

    def tens(x):
        return torch.tensor(np.ascontiguousarray(x), device=dev)

    mods = [tens(models.T), tens((0.05 * models).astype(f32).T),
            tens(np.ones((NFILT, NMODEL), f32))]
    args4 = [tens(data), tens(np.full((BATCH, NFILT), 0.25, f32)),
             tens(dmask)] + mods
    args8 = [tens(data8), tens(np.full((N8, NFILT), 0.25, f32)),
             tens(np.ones((N8, NFILT), f32))] + mods
    return (args4, args8, zl, zl8, GK.gl_table(NFILT, dev),
            float(np.float32(NFILT * 1.8378770664093453)))


def _timed(torch, fn):
    """Milliseconds of `fn()` on the current stream (CUDA events)."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1)


def _turns(torch, reps, old_fn, new_fn):
    """Median ms of `old_fn` and `new_fn`, after one warm call each, over
    `reps` turns of old, new, new, old."""
    old_fn(), new_fn()
    old, new = [], []
    for _ in range(reps):
        old.append(_timed(torch, old_fn))
        new.append(_timed(torch, new_fn))
        new.append(_timed(torch, new_fn))
        old.append(_timed(torch, old_fn))
    return statistics.median(old), statistics.median(new)


def _ab_band(args, report, card, tree, out_dir):
    """The band stacks against the earlier tree's dense kernels."""
    import numpy as np
    import torch

    from ..kernels import build
    from ..kernels import general as GK
    from ..ops import fused as TF
    from ..ops import kde as TK

    dev = torch.device("cuda")
    extra, libs_paths = {}, []
    if args.stamps:
        extra["stamps"] = ["-DFZ_STAMPS"]
    for name, flags in extra.items():
        path = out_dir / f"libfz_ab_band_{len(libs_paths)}.so"
        libs_paths.append(path)
        out_dir.mkdir(parents=True, exist_ok=True)
        extra[name] = (subprocess.Popen(
            [build.nvcc_path(), *build._NVCC_FLAGS, *flags, "-Xptxas", "-v",
             "-I", str(build._SRC_DIR), "-shared", "-o", str(path),
             str(build._SRC_DIR / "lnl_general.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            path, flags)
    ref_procs = _start_nvcc(build, tree / "frankenz_tpu_torch" / "csrc",
                            out_dir / "ref", ("lnl_general.cu",
                                              "lnl_freescale.cu"))
    pkg_procs = _start_nvcc(build, build._SRC_DIR, out_dir / "package",
                            ("lnl_general.cu",))
    build.build()
    pkg = build.load()
    ref_text = _finish_nvcc(build, ref_procs, out_dir / "ref" /
                            "libfz_ab_ref.so")
    ref = _bind_ref(out_dir / "ref" / "libfz_ab_ref.so", topk=False)
    pkg_ptxas = build.parse_ptxas(_finish_nvcc(build, pkg_procs))

    args4, args8, zl, zl8, gl, nd_full = _inputs(np, torch, GK, dev)
    pdict = TK.PDFDict(np.linspace(0.0, 4.0, NGRID),
                       np.linspace(0.01, 0.5, 100))
    G = TK.kernel_matrix_dict(pdict, *pdict.fit(zl, np.full(NMODEL, 0.1)),
                              device=dev).to(torch.float32).contiguous()
    G8 = TK.kernel_matrix_dict(pdict, *pdict.fit(zl8, np.full(NMODEL, 0.1)),
                               device=dev).to(torch.float32).contiguous()
    threads = min(-(-NGRID // 32) * 32, 512)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {rc}")

    timed = functools.partial(_timed, torch)
    turns = functools.partial(_turns, torch, args.reps)

    def row_err(got, want):
        scale = want.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
        return float(((got - want).abs() / scale).max())

    # band_sort of config 4's G, and the band layout.
    bs = GK.band_sort(G, *args4[3:6])
    torch.cuda.synchronize()
    report["band_sort_ms"] = statistics.median(
        timed(lambda: GK.band_sort(G, *args4[3:6])) for _ in range(5))
    cols = (bs.bands[:, 1] - bs.bands[:, 0]).double()
    report["band"] = dict(cols_mean=float(cols.mean()),
                          cols_max=int(cols.max()), width=bs.width,
                          smem=pkg.fz_lnl_band_smem(NFILT, bs.G.shape[1],
                                                    bs.width, 0),
                          blocks_per_sm={
                              "onepass": pkg.fz_lnl_band_blocks(
                                  NFILT, bs.G.shape[1], bs.width, 0),
                              "cut_stack": pkg.fz_lnl_band_blocks(
                                  NFILT, bs.G.shape[1], bs.width, 1)})
    # Registers and spills of the fixed-scale masked dim-prior
    # instantiations (mangled names: the bool after the pair is CUT).
    inst = "FixedPairILb0ELb1ELb0E"
    report["ptxas"] = {
        "ref": {k: v for k, v in build.parse_ptxas(ref_text).items()
                if inst in k and ("lnl_onepass_kernel" in k
                                  or "lnl_stack_kernel" in k)},
        "band": {k: v for k, v in pkg_ptxas.items()
                 if inst in k and "lnl_band_kernel" in k}}

    # The masked 65,536 batch: one pass.
    B = BATCH
    pdf_o = torch.empty((B, NGRID), device=dev)
    lm_o, lv_o = torch.empty(B, device=dev), torch.empty(B, device=dev)

    def old_onepass():
        check(ref.fz_lnl_onepass(
            *[t.data_ptr() for t in args4], gl.data_ptr(), G.data_ptr(),
            pdf_o.data_ptr(), lm_o.data_ptr(), lv_o.data_ptr(), B, NMODEL,
            NFILT, NGRID, 0, 1, 0, nd_full, None, 1, 1, threads, stream()),
            "earlier lnl_onepass")

    def new_onepass():
        return GK.lnl_onepass(*args4[:3], bs)

    ms_o, ms_n = turns(old_onepass, lambda: new_onepass())
    got = new_onepass()
    torch.cuda.synchronize()
    report["onepass_masked_65536"] = dict(
        ref_ms=ms_o, band_ms=ms_n, pdf_row_err=row_err(got[0], pdf_o),
        lmap_equal=bool(torch.equal(got[1], lm_o)),
        levid_max_abs=float((got[2] - lv_o).abs().max()))
    print(f"ab_band lnl_onepass masked {B}: earlier {ms_o:.3f} ms, band "
          f"{ms_n:.3f} ms, {report['onepass_masked_65536']} | card {card}",
          flush=True)
    del got

    # The cut stack at cdf_thresh 2e-4.
    lmap, levid, vals, cnts = GK.lnl_reduce_topk(*args4, T=8)
    cut, tie, nkeep, _ = TF.cdf_cut(vals, cnts, levid, CDF_THRESH)
    cut, tie, nkeep = cut.contiguous(), tie.contiguous(), nkeep.contiguous()

    def old_cut():
        check(ref.fz_lnl_cut_stack(
            *[t.data_ptr() for t in args4], gl.data_ptr(), G.data_ptr(),
            cut.data_ptr(), levid.data_ptr(), tie.data_ptr(),
            nkeep.data_ptr(), pdf_o.data_ptr(), B, NMODEL, NFILT, NGRID, 0,
            1, 0, nd_full, None, 1, 1, threads, stream()),
            "earlier lnl_cut_stack")

    def new_cut():
        return GK.lnl_cut_stack(*args4[:3], bs, cut, levid, tie, nkeep)

    ms_o, ms_n = turns(old_cut, lambda: new_cut())
    got = new_cut()
    torch.cuda.synchronize()
    report["cut_stack_masked_65536"] = dict(
        ref_ms=ms_o, band_ms=ms_n, pdf_row_err=row_err(got, pdf_o),
        split_rows=int((nkeep > 0).sum()))
    print(f"ab_band lnl_cut_stack masked {B}: earlier {ms_o:.3f} ms, band "
          f"{ms_n:.3f} ms, {report['cut_stack_masked_65536']} | card "
          f"{card}", flush=True)
    libs = {}
    for name, (proc, path, flags) in extra.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{out}")
        libs[name] = _bind_band(path)
        report.setdefault("builds", {})[name] = {
            "flags": flags, "ptxas": {k: v for k, v in build.parse_ptxas(
                out).items() if "lnl_band_kernel" in k and inst in k}}
    if args.stamps:
        lib = libs["stamps"]
        cyc = (ctypes.c_ulonglong * 8)()
        report["stamps"] = {}
        for name, call in (("lnl_onepass", new_onepass),
                           ("lnl_cut_stack", new_cut)):
            check(lib.fz_lnl_band_stamps(cyc), "stamps")
            ms = timed(lambda: _with_lib(build, lib, call))
            check(lib.fz_lnl_band_stamps(cyc), "stamps")
            tiles, blocks = max(1, cyc[5]), max(1, cyc[6])
            report["stamps"][name] = {
                "ms": ms, "tiles": cyc[5], "blocks": cyc[6],
                "cycles_per_tile": {part: cyc[i] / tiles for i, part in
                                    enumerate(STAMP_PARTS[:3])},
                "cycles_per_block": {STAMP_PARTS[3]: cyc[3] / blocks}}
            print(f"ab_band stamps {name}: {report['stamps'][name]} | card "
                  f"{card}", flush=True)
    del got, pdf_o, lmap, vals, cnts

    # Free scale with model errors, config 8's batch.
    tm = TF.group_width(NMODEL, TM)
    sw8 = GK.scale_sweeps(*args8, tm=tm, full_mask=True)
    bs8 = GK.band_sort(G8, *args8[3:6])
    pdf8 = torch.empty((N8, NGRID), device=dev)
    lm8, lv8 = torch.empty(N8, device=dev), torch.empty(N8, device=dev)
    fl8 = dict(full_mask=True, free_scale=True, sweeps=sw8, tm=tm)

    def old_fs():
        check(ref.fz_lnl_onepass_fs(
            *[t.data_ptr() for t in args8], gl.data_ptr(), G8.data_ptr(),
            pdf8.data_ptr(), lm8.data_ptr(), lv8.data_ptr(), N8, NMODEL,
            NFILT, NGRID, 1, 1, 0, nd_full, sw8.data_ptr(),
            -(-NMODEL // tm), tm, threads, stream()),
            "earlier lnl_onepass_fs")

    def new_fs():
        return GK.lnl_onepass(*args8[:3], bs8, **fl8)

    ms_o, ms_n = turns(old_fs, lambda: new_fs())
    got = new_fs()
    torch.cuda.synchronize()
    report["onepass_fs_config8_16384"] = dict(
        ref_ms=ms_o, band_ms=ms_n, pdf_row_err=row_err(got[0], pdf8),
        mean_sweeps=float(sw8.float().mean()))
    print(f"ab_band lnl_onepass_fs config 8 {N8}: earlier {ms_o:.3f} ms, "
          f"band {ms_n:.3f} ms, {report['onepass_fs_config8_16384']} | card "
          f"{card}", flush=True)
    del got, pdf8, sw8, bs8, args8, G8

    # The product alone: a dense float32 weight chunk by G, no TF32.
    w = torch.rand((CHUNK, NMODEL), device=dev)
    mm = [timed(lambda: torch.matmul(w, G)) for _ in range(4)]
    report["matmul_dense_32768_ms"] = statistics.median(mm[1:])
    print(f"ab_band torch.matmul ({CHUNK} x {NMODEL}) @ ({NMODEL} x "
          f"{NGRID}), TF32 off: {report['matmul_dense_32768_ms']:.3f} ms | "
          f"card {card}", flush=True)
    del w
    torch.cuda.empty_cache()



def _ab_topk(args, report, card, tree, out_dir):
    """`lnl_reduce_topk` against the earlier tree's `lnl_reduce` +
    `lnl_topk`, bit for bit."""
    import numpy as np
    import torch

    from ..kernels import build
    from ..kernels import general as GK
    from ..ops import fused as TF

    dev = torch.device("cuda")
    sources = ("lnl_general.cu", "lnl_freescale.cu")
    ref_procs = _start_nvcc(build, tree / "frankenz_tpu_torch" / "csrc",
                            out_dir / "ref", sources)
    pkg_procs = _start_nvcc(build, build._SRC_DIR, out_dir / "package",
                            sources)
    report["build_s"] = build.build()
    lib = out_dir / "ref" / "libfz_ab_ref.so"
    ref_text = _finish_nvcc(build, ref_procs, lib)
    ref = _bind_ref(lib, topk=True)
    pkg_text = _finish_nvcc(build, pkg_procs)

    def masked_dim_prior(text, *names):
        # The named kernels' masked dim-prior instantiations, with model
        # errors and without.
        return {k: v for k, v in build.parse_ptxas(text).items()
                if any(n in k for n in names)
                and ("PairILb0ELb1ELb0E" in k or "PairILb0ELb1ELb1E" in k)}

    report["ptxas"] = {
        "ref": masked_dim_prior(ref_text, "lnl_reduce_kernel",
                                "lnl_topk_kernel"),
        "package": masked_dim_prior(pkg_text, "lnl_reduce_topk_kernel")}
    print(f"ab_band --topk ptxas: {report['ptxas']}", flush=True)

    args4, args8, _, _, gl, nd_full = _inputs(np, torch, GK, dev)
    args8 = [x[:N_SMALL] for x in args8[:3]] + args8[3:]
    stream = torch.cuda.current_stream().cuda_stream

    def old_pair(a, fl, outs):
        """The earlier tree's lnl_reduce then lnl_topk into `outs`."""
        B = a[0].shape[0]
        sw = fl.get("sweeps")
        sweep = ((sw.data_ptr(), sw.shape[1], fl["tm"]) if sw is not None
                 else (None, 1, 1))
        flags = (int(fl.get("full_mask", False)), 1,
                 int(fl.get("ignore_model_err", False)))
        sfx = "_fs" if fl.get("free_scale") else ""
        ptrs = [x.data_ptr() for x in a] + [gl.data_ptr()]
        rc = getattr(ref, "fz_lnl_reduce" + sfx)(
            *ptrs, outs[0].data_ptr(), outs[1].data_ptr(), B, NMODEL, NFILT,
            *flags, nd_full, *sweep, stream)
        rc = rc or getattr(ref, "fz_lnl_topk" + sfx)(
            *ptrs, outs[2].data_ptr(), outs[3].data_ptr(), B, NMODEL, NFILT,
            T, *flags, nd_full, *sweep, stream)
        if rc:
            raise RuntimeError(f"earlier lnl_reduce / lnl_topk: CUDA error "
                               f"{rc}")

    def compare(name, a, fl):
        B = a[0].shape[0]
        outs = [torch.empty(B, device=dev), torch.empty(B, device=dev),
                torch.empty((B, T), device=dev),
                torch.empty((B, T), device=dev)]
        ms_old, ms_new = _turns(torch, args.reps,
                                lambda: old_pair(a, fl, outs),
                                lambda: GK.lnl_reduce_topk(*a, T=T, **fl))
        got = GK.lnl_reduce_topk(*a, T=T, **fl)
        old_pair(a, fl, outs)
        torch.cuda.synchronize()
        equal = {k: bool(torch.equal(g, w)) for k, g, w in zip(
            ("lmap", "levid", "vals", "cnts"), got, outs)}
        if not all(equal.values()):
            raise SystemExit(f"{name}: lnl_reduce_topk differs from the "
                             f"earlier lnl_reduce + lnl_topk ({equal})")
        report[name] = dict(ref_ms=ms_old, reduce_topk_ms=ms_new,
                            bit_equal=True)
        print(f"ab_band --topk {name}: earlier lnl_reduce + lnl_topk "
              f"{ms_old:.3f} ms, lnl_reduce_topk {ms_new:.3f} ms, bit for "
              f"bit | card {card}", flush=True)

    fixed = dict(full_mask=False)
    small4 = [x[:N_SMALL] for x in args4[:3]] + args4[3:]
    compare("fixed_masked_65536", args4, fixed)
    compare("fixed_masked_2048", small4, fixed)
    ime = dict(full_mask=False, free_scale=True, ignore_model_err=True)
    compare("free_ime_masked_65536", args4, ime)
    compare("free_ime_masked_2048", small4, ime)
    tm = TF.group_width(NMODEL, TM)
    sw8 = GK.scale_sweeps(*args8, tm=tm, full_mask=True)
    compare("free_me_config8_2048", args8,
            dict(full_mask=True, free_scale=True, sweeps=sw8, tm=tm))
    del args4, args8, small4, sw8
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref-tree", required=True)
    ap.add_argument("--out", default=None,
                    help="default build/ab_band, build/ab_topk with --topk")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-walls", action="store_true")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--stamps", action="store_true")
    mode.add_argument("--topk", action="store_true")
    args = ap.parse_args(argv)
    name = "ab_topk" if args.topk else "ab_band"

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_band needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = _card()
    print(card, flush=True)
    tree = Path(args.ref_tree).resolve()
    out_dir = Path(args.out or f"build/{name}")
    report = {"card": card, "reps": args.reps, "ref_tree": str(tree)}
    (_ab_topk if args.topk else _ab_band)(args, report, card, tree, out_dir)

    if not args.no_walls:
        modes = ("cdf",) if args.topk else MODES
        here = Path.cwd()
        walls = {"ref": [], "package": []}
        for who in ("ref", "package", "package", "ref"):
            walls[who].append(_walls(tree if who == "ref" else here, who,
                                     modes))
        report["fit_predict_131072"] = {
            who: {mode: statistics.median(
                w for run in runs for w in run["walls"][mode])
                for mode in modes}
            for who, runs in walls.items()}
        report["fit_predict_walls"] = walls
        print(f"{name} fit_predict {N_E2E} masked (median walls, s): "
              f"{report['fit_predict_131072']} | card {card}", flush=True)
        if args.topk:
            digests = {run["sha256"]["cdf"] for runs in walls.values()
                       for run in runs}
            report["fit_predict_cdf_bit_equal"] = len(digests) == 1
            if len(digests) != 1:
                raise SystemExit("the trees' cdf fit_predict outputs differ")

    out_dir.mkdir(parents=True, exist_ok=True)
    line = json.dumps(report)
    (out_dir / f"{name}.json").write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
