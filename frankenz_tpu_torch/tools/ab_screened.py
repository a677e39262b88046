"""The screened route's kernels against a reference build of them, in
turns.

    python -m frankenz_tpu_torch.tools.ab_screened (--ref REF.cu |
        --ref-tree DIR) [--out DIR] [--reps N] [--no-walls]

Run from the root of a checkout on a machine with a CUDA card and
`nvcc`.  `REF.cu` is another version of ``csrc/chi2_screened.cu``: the
first design of the two passes (``fz_chi2_brackets_screened`` takes no
model-row stride, ``fz_chi2_stack_screened`` its thread count before the
stream; it exports ``fz_chi2_stack_screened_max_threads``) or a later one
with the package's signatures (e.g. an earlier commit's file, from ``git
archive``); `DIR` is an earlier commit's tree (``git archive <commit>
frankenz_tpu_torch | tar -x -C DIR``), whose
``frankenz_tpu_torch/csrc/chi2_screened.cu`` is the reference.  The
reference is compiled alone, with its own directory and then ``csrc/``
on the include path, into its own library and loaded beside the
package's.  Against a later design s must be bit-equal too.

At config-4 widths (chip_smoke.py's generator: 5 filters, 100,000
models, the 301-point `PDFDict` grid; the route's 512-model subtiles and
home tiles, 32-object blocks) and at B = 2,048 and 65,536 it
- checks each package pass against its plain version at 2,048 (pass A
  bit for bit; pass B s 1e-5 relative, PDFs 1e-5 of each row's largest
  value) and against the reference at both sizes (brackets and pdf bit
  for bit, s 1e-5 relative);
- times reference, package, package, reference (CUDA events, median of
  `--reps` launches each), for pass A, pass B, and pass B with its dot
  gate shut (cut_dot at -inf: the same weights and s, no stack dot);
- times the glue after pass A (`stack_gates`: the cuts, the visit table,
  ph) in the package alone, by CUDA events and by its device busy time
  and launches under torch.profiler (the seed stage's `sort_and_bound`
  in both designs too, with the one-warp reference);
- when the reference holds another design of the seed stage's kernel
  (``fz_screen_bound_seed``), that kernel against the package's, bit for
  bit and in turns;
- when the reference holds the one-warp seed kernel (``fz_screen_seed``,
  before the seed stage was one kernel): the earlier seed stage (the
  glue's torch bounds, anchor seed, block minima and home tiles, that
  kernel, the two seeds' torch.minimum; the torch is the package's
  `subtile_bounds_plain` / `anchor_seed_plain`, the earlier glue's code
  moved unchanged) against `screen_bound_seed`, bit for bit (bounds,
  bmin, start, seed) and in turns, both alone and inside the whole
  `sort_and_bound` (the locality sort, the sorted copies, the boxes);
- prints `nvcc -Xptxas -v`'s registers, spills and stack of both builds'
  kernels, each launch's dynamic shared memory, and the seed stage's
  SASS instructions a pair and a subtile with its issue floor
  (`seed_sass`);
- compares passes A and B's SASS in the two builds (`cuobjdump -sass`,
  every instruction's text) and reports whether each is identical, which
  the run requires with `--ref-tree`;
- with `--ref-tree` and unless `--no-walls`, times full-mask
  `BruteForce.fit_predict` over 131,072 objects in each tree, each in its
  own process, in turns (earlier, package, package, earlier; a warm-up
  and 3 walls a process), with a SHA-256 of the PDFs, lmap and levid,
  which must be one digest for both trees.
It prints one JSON line and writes it to ``DIR/ab_screened.json``; it
exits non-zero when a check fails.
"""

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

from . import sweep_stats as SS

NMODEL, NFILT, NGRID, N_E2E = 100_000, 5, 301, 131_072
SIZES = (2_048, 65_536)
PASSES = ("chi2_brackets_screened", "chi2_stack_screened")
SOURCE = "chi2_screened.cu"
# Full-mask `BruteForce.fit_predict` over N_E2E objects in one tree (its
# own process): a warm-up, 3 walls, and a SHA-256 of PDFs, lmap, levid.
_WALLS = r"""
import hashlib, json, time
import numpy as np, torch
from frankenz_tpu_torch.models import BruteForce
from frankenz_tpu_torch.ops import kde as TK
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
M, F, NG, N = %d, %d, %d, %d
f32 = np.float32
rng = np.random.default_rng(0)
models = rng.uniform(1, 10, (M, F)).astype(f32)
models_err = (0.05 * models).astype(f32)
zl = rng.uniform(0, 3.5, M)
ze = np.full(M, 0.1)
pdict = TK.PDFDict(np.linspace(0.0, 4.0, NG), np.linspace(0.01, 0.5, 100))
data = rng.uniform(1, 10, (N, F)).astype(f32)
data_err = np.full((N, F), 0.25, f32)
ones = np.ones((N, F), f32)
bf = BruteForce(models, models_err, np.ones_like(models), device="cuda")
kw = dict(label_dict=pdict, verbose=False, return_gof=True)
def run():
    return bf.fit_predict(data, data_err, ones, zl, ze, **kw)
run()
torch.cuda.synchronize()
walls = []
for _ in range(3):
    t0 = time.perf_counter()
    pdfs, (lmap, levid) = run()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
digest = hashlib.sha256()
for x in (pdfs, lmap, levid):
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


def _ref_lib(build, src):
    """Compile `src` alone into build/.../libfz_ref.so and bind its two
    passes: the first design's signatures when it exports
    fz_chi2_stack_screened_max_threads (`first_design` True), else the
    package's; and its one-warp seed kernel (`fz_screen_seed`,
    `one_warp_seed`) or its seed stage's (`fz_screen_bound_seed`,
    `seed_stage`) when it has one."""
    out = build.library_path().parent / "libfz_ref.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build._NVCC_FLAGS, "-I",
                    str(src.parent), "-I", str(build._SRC_DIR), "-shared",
                    "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.first_design = hasattr(lib, "fz_chi2_stack_screened_max_threads")
    if lib.first_design:
        lib.fz_chi2_brackets_screened.argtypes = [P] * 8 + [I] * 5 + [F, I,
                                                                       P]
        lib.fz_chi2_stack_screened.argtypes = ([P] * 14 + [I] * 6
                                               + [F, I, F] + [I] * 3 + [P])
        lib.fz_chi2_stack_screened_max_threads.argtypes = []
        lib.fz_chi2_stack_screened_max_threads.restype = I
    else:
        lib.fz_chi2_brackets_screened.argtypes = [P] * 8 + [I] * 6 + [F, I,
                                                                       P]
        lib.fz_chi2_stack_screened.argtypes = ([P] * 14 + [I] * 7
                                               + [F, I, F] + [I] * 2 + [P])
    for fn in (lib.fz_chi2_brackets_screened, lib.fz_chi2_stack_screened):
        fn.restype = I
    lib.one_warp_seed = hasattr(lib, "fz_screen_seed")
    if lib.one_warp_seed:
        lib.fz_screen_seed.argtypes = [P] * 6 + [I] * 4 + [F, I, P]
        lib.fz_screen_seed.restype = I
    lib.seed_stage = hasattr(lib, "fz_screen_bound_seed")
    if lib.seed_stage:
        lib.fz_screen_bound_seed.argtypes = ([P] * 11 + [I] * 9 + [F] * 5
                                             + [I, P])
        lib.fz_screen_bound_seed.restype = I
    return lib


def _dump(build, lib_path):
    """`cuobjdump -sass` of `lib_path` (text), or None without the tool."""
    tool = SS._cuobjdump(build)
    if tool is None:
        return None
    return subprocess.run([tool, "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout


def _sass(text):
    """{pass: [instruction text]} of passes A and B in `cuobjdump -sass`
    text (addresses and encodings left out)."""
    out = {}
    for part in re.split(r"\n\s*Function : ", text or "")[1:]:
        head = part.split("\n", 1)[0]
        for k in PASSES:
            if f"{k}_kernel" in head:
                out[k] = [m.group(2).strip()
                          for m in SS._INSN.finditer(part)]
    return out


def parse_seed_sass(text, F=NFILT):
    """The seed stage's SASS counts in `cuobjdump -sass` text, from the F
    instantiation of `screen_bound_seed_kernel`: the instructions a pair
    of its pair loops (the shortest loop whose fast path, in
    `ab_fullmask.fast_path`'s sense, holds at least 4 F divides: its
    fast path over its divides / F) and a warp's instructions a subtile
    of its bounds loop (the shortest loop with a warp shuffle and F to 4
    F - 1 divides on its fast path, likewise).  {"per_pair",
    "per_subtile", "function"} or {"error": ...}."""
    from .ab_fullmask import fast_path

    loops, name = SS.sass_loops(text, "screen_bound_seed_kernel",
                                f"ILi{F}E")
    pair, sub = [], []
    for lp in loops:
        fast = fast_path(lp)
        rcp = sum("MUFU.RCP" in t for t in fast)
        if rcp >= 4 * F:
            pair.append((len(lp), len(fast) / (rcp // F)))
        elif rcp >= F and any("SHFL" in t for t in fast):
            sub.append((len(lp), len(fast) / (rcp // F)))
    if not pair or not sub:
        return {"error": f"no pair loop ({len(pair)}) or bounds loop "
                         f"({len(sub)}) on the fast path", "function": name}
    return {"per_pair": min(pair)[1], "per_subtile": min(sub)[1],
            "function": name}


def seed_sass(build, lib_path=None, F=NFILT):
    """`parse_seed_sass` of the package's library (or `lib_path`)."""
    text = _dump(build, lib_path or build.library_path())
    if text is None:
        return {"error": "no cuobjdump"}
    return parse_seed_sass(text, F)


def seed_issue_floor(sass, pairs, subtiles, sms, clock_mhz):
    """Milliseconds the schedulers need to issue the seed stage's pairs
    (32 a warp instruction) and its (subtile, object block) bounds at
    `seed_sass`'s counts."""
    return (SS.issue_floor(pairs / 32, sass["per_pair"], sms, clock_mhz)
            + SS.issue_floor(subtiles, sass["per_subtile"], sms, clock_mhz))


def _ptxas(rep):
    """{kernel: report} of the two passes (and the seed stage's F = 5
    instantiation, where there is one) in a `ptxas_report`."""
    return {k: v for name, v in rep.items()
            for k in ("chi2_brackets_screened_kernel",
                      "chi2_stack_screened_kernel",
                      f"screen_bound_seed_kernelILi{NFILT}E") if k in name}


def _device_ms(event):
    dt = getattr(event, "self_device_time_total", None)
    return (event.self_cuda_time_total if dt is None else dt) / 1e3


def _walls(tree):
    env = dict(os.environ, PYTHONPATH=str(tree))
    run = subprocess.run(
        [sys.executable, "-c", _WALLS % (NMODEL, NFILT, NGRID, N_E2E)],
        cwd=str(tree), env=env, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"fit_predict walls in {tree} failed:\n"
                           f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    line = [x for x in run.stdout.splitlines() if x.startswith("WALLS ")]
    return json.loads(line[-1][len("WALLS "):])


def main(argv=None):
    import numpy as np
    import torch

    from ..kernels import build
    from ..kernels import screened as SCK
    from ..kernels.general import _check_rc, _stream
    from ..ops import kde
    from ..ops import screen as SC

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ref_arg = ap.add_mutually_exclusive_group(required=True)
    ref_arg.add_argument("--ref")
    ref_arg.add_argument("--ref-tree")
    ap.add_argument("--out", default="build/ab_screened")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-walls", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    card = _card()
    print(card, flush=True)

    ref_src = (Path(args.ref) if args.ref else Path(args.ref_tree)
               / "frankenz_tpu_torch" / "csrc" / SOURCE).resolve()
    build.load()
    ref = _ref_lib(build, ref_src)
    ptxas = {"package": _ptxas(build.ptxas_report(SOURCE)),
             "reference": _ptxas(build.ptxas_report(ref_src))}
    lib = build.load()
    smem = {"screen_bound_seed": lib.fz_screen_bound_seed_smem(NFILT),
            "chi2_brackets_screened": lib.fz_chi2_brackets_screened_smem(
                NFILT),
            "chi2_stack_screened": lib.fz_chi2_stack_screened_smem(
                NFILT, NGRID)}
    pkg_text = _dump(build, build.library_path())
    sass = {"package": _sass(pkg_text),
            "reference": _sass(_dump(build, build.library_path().parent
                                     / "libfz_ref.so"))}
    sass_identical = {k: k in sass["package"]
                      and sass["package"][k] == sass["reference"].get(k)
                      for k in PASSES}
    seed_counts = parse_seed_sass(pkg_text or "")
    clock = SS.max_sm_clock()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"ptxas -v: {json.dumps(ptxas)}; dynamic shared memory "
          f"{smem} bytes; passes' SASS identical to the reference's "
          f"{sass_identical}; seed stage SASS {json.dumps(seed_counts)}, "
          f"max SM clock {clock} MHz | card {card}", flush=True)

    rng = np.random.default_rng(0)
    f32 = np.float32
    models = rng.uniform(1, 10, (NMODEL, NFILT)).astype(f32)
    models_err = (0.05 * models).astype(f32)
    zlabels = rng.uniform(0, 3.5, NMODEL)
    pdict = kde.PDFDict(np.linspace(0.0, 4.0, NGRID),
                        np.linspace(0.01, 0.5, 100))
    G = kde.kernel_matrix_dict(pdict, *pdict.fit(zlabels,
                                                 np.full(NMODEL, 0.1)),
                               device=dev).to(torch.float32).contiguous()
    data = rng.uniform(1, 10, (N_E2E, NFILT)).astype(f32)

    def tens(x):
        return torch.tensor(np.ascontiguousarray(x), device=dev)

    def median_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def device_busy(fn):
        """(device ms, kernels and copies) of one warm call of `fn` under
        torch.profiler (`aten::` rows, which repeat their kernels' time,
        left out)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if _device_ms(e) > 0 and not e.key.startswith("aten::")]
        return (sum(_device_ms(e) for e in evs),
                sum(e.count for e in evs))

    def turns(old, new):
        r1, n1, n2, r2 = median_ms(old), median_ms(new), median_ms(new), \
            median_ms(old)
        return {"ref_ms": [r1, r2], "new_ms": [n1, n2]}

    c0, a1 = NFILT - 2.0, 0.5 * NFILT - 1.0
    wthr = float(np.exp(np.log(1e-3)))
    results = {"card": card, "ptxas": ptxas, "dynamic_smem": smem,
               "sass_identical": sass_identical,
               "sass_instructions": {k: len(v) for k, v in
                                     sass["package"].items()},
               "seed_sass": seed_counts, "max_sm_clock_mhz": clock,
               "sms": sms}
    ok_all = (not args.ref_tree or all(sass_identical.values()))
    mT_all, meT_all = tens(models.T), tens(models_err.T)
    for B in SIZES:
        d_b, de_b = tens(data[:B]), tens(np.full((B, NFILT), 0.25, f32))
        srt = SC.sort_and_bound(d_b, de_b, mT_all, meT_all, G, sm=512,
                                tm=512, tb=SCK.TB, ignore_model_err=False)
        sa = (srt.d, srt.de, srt.mT, srt.meT)
        S = srt.bounds.shape[0]
        seed = srt.seed
        check, times, busy = {}, {}, {}

        if ref.one_warp_seed:
            def stage_old(sa=sa):
                """The earlier seed stage on sorted arrays: the glue's
                torch and the one-warp kernel of the reference."""
                boxes = SC.subtile_boxes(sa[2], sa[3], 512)
                bounds = SCK.subtile_bounds_plain(sa[0], sa[1], *boxes,
                                                  False)
                anchor = SCK.anchor_seed_plain(*sa, c0, False)
                nb = SCK.nblocks(B, SCK.TB)
                bmin = torch.nn.functional.pad(
                    bounds, (0, nb * SCK.TB - B), value=torch.inf)
                bmin = bmin.reshape(S, nb, SCK.TB).amin(dim=2)
                start = (torch.argmin(bmin, dim=0) * 512).to(
                    torch.int32).contiguous()
                home = torch.empty(B, device=dev)
                with torch.cuda.device(dev):
                    _check_rc("reference screen_seed", ref.fz_screen_seed(
                        *(t.data_ptr() for t in sa), start.data_ptr(),
                        home.data_ptr(), B, NMODEL, NFILT, 512, c0, 0,
                        _stream(dev)))
                return bounds, bmin, start, torch.minimum(anchor, home)

            def stage_new(sa=sa):
                return SCK.screen_bound_seed(
                    *sa, *SC.subtile_boxes(sa[2], sa[3], 512), sm=512,
                    tm=512, c0=c0)

            def sab_old():
                operm, mperm = SC.locality_sort(d_b, mT_all)
                sorted_ = (d_b[operm].contiguous(), de_b[operm].contiguous(),
                           mT_all[:, mperm].contiguous(),
                           meT_all[:, mperm].contiguous())
                G[mperm].contiguous()
                return stage_old(sorted_)

            def sab_new():
                return SC.sort_and_bound(d_b, de_b, mT_all, meT_all, G,
                                         sm=512, tm=512, tb=SCK.TB,
                                         ignore_model_err=False)

            so, sn = stage_old(), stage_new()
            torch.cuda.synchronize()
            check["seed_stage_equal_ref"] = all(
                SS.same_bits(x, y) for x, y in zip(sn, so))
            check["seed_stage_equal_sorted"] = all(
                SS.same_bits(x, y) for x, y in zip(
                    sn, (srt.bounds, srt.bmin, srt.start, srt.seed)))
            times["seed stage"] = turns(stage_old, stage_new)
            times["sort_and_bound"] = turns(sab_old, sab_new)
            busy["sort_and_bound"] = {"ref": device_busy(sab_old),
                                      "new": device_busy(sab_new)}
            del so, sn
        elif ref.seed_stage:
            boxes = srt.boxes
            consts = [float(x) for x in (
                np.float32(c0), np.float32(c0 * (1.0 + 1e-3)),
                np.float32(1.0 - 1e-4), np.float32(1.0 + 1e-4),
                np.float32(1.0 + 1e-6))]

            def kernel_new():
                return SCK.screen_bound_seed(*sa, *boxes, sm=512, tm=512,
                                             c0=c0)

            def kernel_ref():
                out = (torch.empty_like(srt.bounds),
                       torch.empty_like(srt.bmin),
                       torch.empty_like(srt.start), torch.empty_like(seed))
                A = min(SCK.N_ANCHOR, NMODEL)
                with torch.cuda.device(dev):
                    _check_rc("reference screen_bound_seed",
                              ref.fz_screen_bound_seed(
                                  *(t.data_ptr() for t in sa + boxes + out),
                                  B, NMODEL, NMODEL, NFILT, S, 512, 512, A,
                                  NMODEL // A, *consts, 0, _stream(dev)))
                return out

            kn, kr = kernel_new(), kernel_ref()
            torch.cuda.synchronize()
            check["seed_stage_equal_ref"] = all(
                SS.same_bits(x, y) for x, y in zip(kn, kr))
            times["screen_bound_seed"] = turns(kernel_ref, kernel_new)
            del kn, kr

        def a_new():
            return SCK.chi2_brackets_screened(*sa, srt.bounds, seed, c0=c0,
                                              sm=512)

        def a_ref():
            below = torch.full((B,), -1.0, device=dev)
            above = torch.full_like(below, torch.inf)
            # The model rows' stride after M, from the later design on.
            ld = () if ref.first_design else (NMODEL,)
            with torch.cuda.device(dev):
                _check_rc("reference pass A", ref.fz_chi2_brackets_screened(
                    *(t.data_ptr() for t in sa), srt.bounds.data_ptr(),
                    seed.data_ptr(), below.data_ptr(), above.data_ptr(), B,
                    NMODEL, *ld, NFILT, S, 512, c0, 0, _stream(dev)))
            return below, above

        bn, br = a_new(), a_ref()
        torch.cuda.synchronize()
        check["a_equal_ref"] = all(torch.equal(x, y) for x, y in zip(bn, br))
        gates = SC.stack_gates(srt, *bn, wt_thresh=1e-3)
        gargs = (srt.G, gates.shift, srt.bounds, gates.visit, gates.cut_uf,
                 gates.cut_dot, gates.ph, gates.cut_abs)

        # Pass B also with the dot gate shut (cut_dot at -inf: the run
        # gate keeps cut_abs / cut_uf, so the same weights and s, no dot).
        nodot = list(gargs)
        nodot[5] = torch.full_like(gates.cut_dot, -torch.inf)

        def b_new(g=gargs):
            return SCK.chi2_stack_screened(*sa, *g, a1=a1, sm=512,
                                           wthr=wthr)

        def b_ref(g=gargs):
            pdf = torch.zeros((B, NGRID), device=dev)
            s = torch.zeros(B, device=dev)
            if ref.first_design:
                ld, threads = (), (min(
                    -(-NGRID // 32) * 32,
                    ref.fz_chi2_stack_screened_max_threads()),)
            else:
                ld, threads = (NMODEL,), ()
            with torch.cuda.device(dev):
                _check_rc("reference pass B", ref.fz_chi2_stack_screened(
                    *(t.data_ptr() for t in sa + tuple(g)), pdf.data_ptr(),
                    s.data_ptr(), B, NMODEL, *ld, NFILT, NGRID, S, 512, a1,
                    1, wthr, 0, 1, *threads, _stream(dev)))
            return pdf, s

        (pn, sn), (pr, sr) = b_new(), b_ref()
        torch.cuda.synchronize()
        check["pdf_equal_ref"] = torch.equal(pn, pr)
        check["s_rel_vs_ref"] = float(((sn - sr).abs()
                                       / sr.abs().clamp_min(1e-30)).max())
        check["s_equal_ref"] = torch.equal(sn, sr)
        if B == SIZES[0]:
            bp = SCK.chi2_brackets_screened_plain(*sa, srt.bounds, seed,
                                                  c0=c0, sm=512)
            pp, sp = SCK.chi2_stack_screened_plain(*sa, *gargs, a1=a1,
                                                   sm=512, wthr=wthr)
            check["a_equal_plain"] = all(torch.equal(x, y)
                                         for x, y in zip(bn, bp))
            check["s_rel_vs_plain"] = float(
                ((sn - sp).abs() / sp.abs().clamp_min(1e-30)).max())
            scale = pp.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
            check["pdf_rowrel_vs_plain"] = float(((pn - pp).abs()
                                                  / scale).max())
            del bp, pp, sp
        ok = (check["a_equal_ref"] and check["pdf_equal_ref"]
              and check["s_rel_vs_ref"] <= 1e-5
              and (ref.first_design or check["s_equal_ref"])
              and check.get("a_equal_plain", True)
              and check.get("s_rel_vs_plain", 0.0) <= 1e-5
              and check.get("pdf_rowrel_vs_plain", 0.0) <= 1e-5
              and check.get("seed_stage_equal_ref", True)
              and check.get("seed_stage_equal_sorted", True))
        for name, new, old in (
                ("chi2_brackets_screened", a_new, a_ref),
                ("chi2_stack_screened", b_new, b_ref),
                ("chi2_stack_screened without the dot",
                 lambda: b_new(nodot), lambda: b_ref(nodot))):
            times[name] = turns(old, new)
        fr = [float(x) for x in SC.run_fractions(srt, seed, gates)]
        # The glue after pass A (the cuts, the visit table, ph), which this
        # tool does not compare: the package's alone.
        busy["stack_gates"] = {"new": device_busy(
            lambda: SC.stack_gates(srt, *bn, wt_thresh=1e-3))}
        res = {"checks": check, "ok": ok, "times": times,
               "run_fractions": fr, "stack_gates_ms": median_ms(
                   lambda: SC.stack_gates(srt, *bn, wt_thresh=1e-3)),
               "device_busy_ms_and_launches": busy}
        if "error" not in seed_counts and clock is not None:
            # Pairs: every row's anchors and its block's home tile.
            home = (NMODEL - srt.start.long()).clamp_max(512)
            rows = torch.full_like(home, SCK.TB)
            rows[-1] = B - SCK.TB * (len(rows) - 1)
            pairs = float(B * min(SCK.N_ANCHOR, NMODEL)
                          + (rows * home).sum())
            res["seed_issue_floor_ms"] = seed_issue_floor(
                seed_counts, pairs, S * len(rows), sms, clock)
        results[str(B)] = res
        ok_all = ok_all and ok
        print(f"B={B}: {json.dumps(check)} | " + " | ".join(
            f"{k} ref {v['ref_ms'][0]:.3f}/{v['ref_ms'][1]:.3f} ms, new "
            f"{v['new_ms'][0]:.3f}/{v['new_ms'][1]:.3f} ms"
            for k, v in times.items())
            + f" | stack_gates {res['stack_gates_ms']:.3f} ms, seed issue "
            f"floor {res.get('seed_issue_floor_ms')} ms | device busy (ms, "
            f"launches) {json.dumps(busy)}"
            + f" | run fractions {fr} | card {card}", flush=True)
        del srt, sa, seed, bn, br, gates, gargs, nodot, pn, sn, pr, sr
        torch.cuda.empty_cache()
        if not ok:
            break
    del mT_all, meT_all, G
    torch.cuda.empty_cache()

    if args.ref_tree and not args.no_walls and ok_all:
        tree, here = Path(args.ref_tree).resolve(), Path.cwd()
        walls = {"ref": [], "package": []}
        for who in ("ref", "package", "package", "ref"):
            walls[who].append(_walls(tree if who == "ref" else here))
        digests = sorted({r["sha256"] for runs in walls.values()
                          for r in runs})
        results["fit_predict_walls"] = walls
        results["fit_predict_s"] = {
            who: statistics.median(w for r in runs for w in r["walls"])
            for who, runs in walls.items()}
        results["fit_predict_sha256"] = digests
        ok_all = ok_all and len(digests) == 1
        print(f"ab_screened full-mask fit_predict over {N_E2E} objects "
              f"(median walls, s): {results['fit_predict_s']}, SHA-256 "
              f"{digests} | card {card}", flush=True)

    results["ok"] = ok_all and all(str(B) in results for B in SIZES)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    line = json.dumps(results)
    (out / "ab_screened.json").write_text(line + "\n")
    print(line, flush=True)
    if not results["ok"]:
        raise SystemExit("a check failed")


if __name__ == "__main__":
    main()
