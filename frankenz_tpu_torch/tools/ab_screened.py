"""Screened passes A and B against a reference build of them, in turns.

    python -m frankenz_tpu_torch.tools.ab_screened --ref REF.cu \
        [--out DIR] [--reps N]

Run from the root of a checkout on a machine with a CUDA card and
`nvcc`.  `REF.cu` is another version of ``csrc/chi2_screened.cu``: the
first design of the two passes (``fz_chi2_brackets_screened`` takes no
model-row stride, ``fz_chi2_stack_screened`` its thread count before the
stream; it exports ``fz_chi2_stack_screened_max_threads``) or a later one
with the package's signatures (e.g. an earlier commit's file, from ``git
archive``); it is compiled alone, with its own directory and then
``csrc/`` on the include path, into its own library and loaded beside the
package's.  Against a later design s must be bit-equal too.

At config-4 widths (chip_smoke.py's generator: 5 filters, 100,000
models, the 301-point `PDFDict` grid; the route's 512-model subtiles and
32-object blocks) and at B = 2,048 and 65,536 it
- checks each package kernel against its plain version at 2,048 (pass A
  bit for bit; pass B s 1e-5 relative, PDFs 1e-5 of each row's largest
  value) and against the reference at both sizes (brackets and pdf bit
  for bit, s 1e-5 relative);
- times reference, package, package, reference (CUDA events, median of
  `--reps` launches each), for pass A, pass B, and pass B with its dot
  gate shut (cut_dot at -inf: the same weights and s, no stack dot);
- prints `nvcc -Xptxas -v`'s registers, spills and stack of both builds'
  kernels, and each launch's dynamic shared memory;
- compares the three kernels' SASS in the two builds (`cuobjdump -sass`,
  every instruction's text) and reports whether each is identical.
It prints one JSON line and writes it to ``DIR/ab_screened.json``.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

NMODEL, NFILT, NGRID, N_E2E = 100_000, 5, 301, 131_072
SIZES = (2_048, 65_536)
KERNELS = ("screen_seed", "chi2_brackets_screened", "chi2_stack_screened")


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
    package's."""
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
    return lib


def _sass(build, lib_path):
    """{kernel: [instruction text]} of the three screened kernels in
    `cuobjdump -sass` of `lib_path` (addresses and encodings left out)."""
    from . import sweep_stats as SS

    tool = SS._cuobjdump(build)
    if tool is None:
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        head = part.split("\n", 1)[0]
        for k in KERNELS:
            if f"{k}_kernel" in head:
                out[k] = [m.group(2).strip()
                          for m in SS._INSN.finditer(part)]
    return out


def _ptxas(build, source):
    """{kernel: report} of the two passes in `source`."""
    rep = build.ptxas_report(source)
    return {k: v for name, v in rep.items()
            for k in ("chi2_brackets_screened_kernel",
                      "chi2_stack_screened_kernel") if k in name}


def main(argv=None):
    import numpy as np
    import torch

    from ..kernels import build
    from ..kernels import screened as SCK
    from ..kernels.general import _check_rc, _stream
    from ..ops import kde
    from ..ops import screen as SC

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref", required=True)
    ap.add_argument("--out", default="build/ab_screened")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    card = _card()
    print(card, flush=True)

    build.load()
    ref = _ref_lib(build, Path(args.ref).resolve())
    ptxas = {"package": _ptxas(build, "chi2_screened.cu"),
             "reference": _ptxas(build, Path(args.ref).resolve())}
    lib = build.load()
    smem = {"chi2_brackets_screened": lib.fz_chi2_brackets_screened_smem(
                NFILT),
            "chi2_stack_screened": lib.fz_chi2_stack_screened_smem(
                NFILT, NGRID)}
    sass = {"package": _sass(build, build.library_path()),
            "reference": _sass(build, build.library_path().parent
                               / "libfz_ref.so")}
    sass_identical = {k: k in sass["package"]
                      and sass["package"][k] == sass["reference"].get(k)
                      for k in KERNELS}
    print(f"ptxas -v: {json.dumps(ptxas)}; dynamic shared memory "
          f"{smem} bytes; SASS identical to the reference's "
          f"{sass_identical} | card {card}", flush=True)

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

    c0, a1 = NFILT - 2.0, 0.5 * NFILT - 1.0
    wthr = float(np.exp(np.log(1e-3)))
    results = {"card": card, "ptxas": ptxas, "dynamic_smem": smem,
               "sass_identical": sass_identical,
               "sass_instructions": {k: len(v) for k, v in
                                     sass["package"].items()}}
    for B in SIZES:
        srt = SC.sort_and_bound(
            tens(data[:B]), tens(np.full((B, NFILT), 0.25, f32)),
            tens(models.T), tens(models_err.T), G, sm=512, tm=512,
            tb=SCK.TB, ignore_model_err=False)
        sa = (srt.d, srt.de, srt.mT, srt.meT)
        S = srt.bounds.shape[0]
        seed = torch.minimum(srt.seed, SCK.screen_seed(
            *sa, srt.start, width=512, c0=c0))

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
        check = {"a_equal_ref": all(torch.equal(x, y)
                                    for x, y in zip(bn, br))}
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
              and check.get("pdf_rowrel_vs_plain", 0.0) <= 1e-5)
        times = {}
        for name, new, old in (
                ("chi2_brackets_screened", a_new, a_ref),
                ("chi2_stack_screened", b_new, b_ref),
                ("chi2_stack_screened without the dot",
                 lambda: b_new(nodot), lambda: b_ref(nodot))):
            r1, n1, n2, r2 = (median_ms(old), median_ms(new), median_ms(new),
                              median_ms(old))
            times[name] = {"ref_ms": [r1, r2], "new_ms": [n1, n2]}
        fr = [float(x) for x in SC.run_fractions(srt, seed, gates)]
        results[str(B)] = {"checks": check, "ok": ok, "times": times,
                           "run_fractions": fr}
        print(f"B={B}: {json.dumps(check)} | " + " | ".join(
            f"{k} ref {v['ref_ms'][0]:.3f}/{v['ref_ms'][1]:.3f} ms, new "
            f"{v['new_ms'][0]:.3f}/{v['new_ms'][1]:.3f} ms"
            for k, v in times.items())
            + f" | run fractions {fr} | card {card}", flush=True)
        del srt, sa, seed, bn, br, gates, gargs, nodot, pn, sn, pr, sr
        torch.cuda.empty_cache()
        if not ok:
            break

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    line = json.dumps(results)
    (out / "ab_screened.json").write_text(line + "\n")
    print(line, flush=True)
    if not all(results[str(B)]["ok"] for B in SIZES if str(B) in results) \
            or not all(str(B) in results for B in SIZES):
        raise SystemExit("a check failed")


if __name__ == "__main__":
    main()
