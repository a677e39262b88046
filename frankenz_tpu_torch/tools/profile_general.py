"""Wall times and one `torch.profiler` trace of the general route.

    python -m frankenz_tpu_torch.tools.profile_general [--out DIR] [--reps N]

Run from the root of a checkout on a machine with a CUDA card and
`nvcc`.  At config-4 widths (5 filters, 100,000 models, the 301-point
`PDFDict` grid, chip_smoke.py's generator and its masked data: each band
missing with probability 0.15) it times `BruteForce.fit_predict` over
131,072 masked objects (wt_thresh 1e-3: `lnl_reduce` + `lnl_stack`),
over 65,536 in the cdf mode (cdf_thresh 2e-4: `lnl_reduce` + `lnl_topk`
+ `lnl_cut_stack`) and over 65,536 with no weight threshold (one pass:
`lnl_onepass`), and config 8 (bench.py:612-699: 16,384 noisy scaled
model copies on full masks, free scale with model errors, wt_thresh
1e-3, ltol 1e-4: `scale_sweeps` + free-scale `lnl_reduce` +
`lnl_stack`): one warm-up, `--reps` timed walls, then one run under the
profiler.  It prints the walls, their median, the device busy time
(kernels and copies) and its share of the profiled run's wall, and the
heaviest device operations, and writes ``profile_general.json`` and one
Chrome trace per run to `--out` (default ``build/profile``).
"""

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

NMODEL, NFILT, NGRID, BATCH = 100_000, 5, 301, 65_536
N8 = 16_384


def _device_ms(event):
    dt = getattr(event, "self_device_time_total", None)
    return (event.self_cuda_time_total if dt is None else dt) / 1e3


def main(argv=None):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..kernels import build
    from ..models import BruteForce
    from ..ops import kde

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    build.load()

    rng = np.random.default_rng(0)
    f32 = np.float32
    models = rng.uniform(1, 10, (NMODEL, NFILT)).astype(f32)
    zlabels = rng.uniform(0, 3.5, NMODEL)
    zerrs = np.full(NMODEL, 0.1)
    pdict = kde.PDFDict(np.linspace(0.0, 4.0, NGRID),
                        np.linspace(0.01, 0.5, 100))
    n = 2 * BATCH
    data = rng.uniform(1, 10, (n, NFILT)).astype(f32)
    data_err = np.full((n, NFILT), 0.25, f32)
    dmask = (np.random.default_rng(2).uniform(size=(n, NFILT))
             >= 0.15).astype(f32)
    # Config 8's data: the same models, then its own draws.
    rng8 = np.random.default_rng(0)
    rng8.uniform(1, 10, (NMODEL, NFILT))
    scales = rng8.uniform(0.5, 2.0, (N8, 1))
    data8 = (scales * models[rng8.integers(0, NMODEL, N8)]
             + rng8.normal(0, 0.3, (N8, NFILT))).astype(f32)
    zl8 = rng8.uniform(0, 3.5, NMODEL)
    bf = BruteForce(models, (0.05 * models).astype(f32),
                    np.ones_like(models), device="cuda")
    kw = dict(label_dict=pdict, verbose=False, return_gof=True)

    def masked(rows):
        return (data[:rows], data_err[:rows], dmask[:rows], zlabels, zerrs)

    report = {"card": card}
    for name, call, extra in (
            ("masked_fit_predict", masked(n), {}),
            ("cdf_fit_predict", masked(BATCH), dict(wt_thresh=None,
                                                    cdf_thresh=2e-4)),
            ("onepass_fit_predict", masked(BATCH), dict(wt_thresh=None,
                                                        cdf_thresh=None)),
            ("config8_free_scale_fit_predict",
             (data8, np.full((N8, NFILT), 0.25, f32),
              np.ones((N8, NFILT), f32), zl8, zerrs),
             dict(lprob_kwargs=dict(free_scale=True, ltol=1e-4)))):
        rows = call[0].shape[0]
        bf.fit_predict(*call, **kw, **extra)
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            bf.fit_predict(*call, **kw, **extra)
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            bf.fit_predict(*call, **kw, **extra)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # `aten::` rows repeat the device time of the kernels and copies
        # they launch: left out of the busy sum.
        ops = sorted(((_device_ms(e), e.key, e.count)
                      for e in prof.key_averages()
                      if _device_ms(e) > 0 and not e.key.startswith("aten::")),
                     reverse=True)
        busy = sum(op[0] for op in ops)
        med = statistics.median(walls)
        print(f"== {name}: {rows} objects x {NMODEL} models x {NGRID} grid; "
              f"walls {walls} s, median {med} s = {rows * NMODEL / med} "
              f"pair-evals/s; profiled wall {wall_ms} ms, device busy "
              f"{busy} ms, busy share {busy / wall_ms} | {card}",
              flush=True)
        for ms, key, count in ops[:12]:
            print(f"  {ms:10.3f} ms  {100 * ms / busy:6.2f}%  x{count}  "
                  f"{key[:90]}", flush=True)
        report[name] = dict(rows=rows, walls_s=walls, median_s=med,
                            profiled_wall_ms=wall_ms, device_busy_ms=busy,
                            ops=ops[:20])
        prof.export_chrome_trace(str(out_dir / f"trace_{name}.json"))
    (out_dir / "profile_general.json").write_text(json.dumps(report,
                                                             indent=1))


if __name__ == "__main__":
    main()
