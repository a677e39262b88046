"""Wall times and one `torch.profiler` trace of config 5's two samplers.

    python -m frankenz_tpu_torch.tools.profile_samplers [--out DIR]
        [--reps N] [--traces]

Run from the root of a checkout on a machine with a CUDA card and
`nvcc`.  At config 5's widths (bench.py:218-254: 50 bins x 20,000 objects,
Gaussian PDFs of width 1.5 around redshifts drawn from a bump at bin 18,
``default_rng(0)``) it times `population_sampler.run_mcmc(100, thin=400,
mh_steps=3, seed=0)` (40,000 Gibbs steps on the `pop_chain` kernel) and
`hierarchical_sampler.run_mcmc(200, thin=5, seed=0)` (1,000 sweeps in
plain torch), each from a reset sampler: one warm-up, `--reps` timed
walls, then one run under the profiler.  It prints the walls, their
median, the device busy time (kernels and copies; `aten::` rows left out,
as they repeat their kernels' time) and its share of the profiled wall,
and the heaviest device operations.  Then it times the `pop_chain` kernel
alone (CUDA events, median of 3) over 4,000 Gibbs steps at `mh_steps` 1 to
4, on the route the wrapper picks for one chain (a cluster) and on the
block, whose slope is the cost of one proposal pass and whose intercept
that of the gradient pass and the step's fixed work, and over 2,000 steps
with 1 to 264 chains in one launch on the route the wrapper picks for
each count (its cluster size printed beside it; 132 SMs).  It writes
``profile_samplers.json`` to `--out` (default ``build/profile``), and
with `--traces` one Chrome trace per sampler (the hierarchical one holds
~30,000 device operations: tens of MB).

With ``--drift N`` it runs only the carried overlap's drift instead: one
chain N times config 5's length (N x 40,000 Gibbs steps x 3 proposals,
the draw table from seed 0) in one `pop_chain` launch on the cluster
route the wrapper picks and on one block (``cluster=1``), the two held
bit for bit, and prints for each max |ov - pdfs . pos| / ov, the carried
overlaps against pdfs . pos in float64 from the final position, the
accepting steps and the final lnpost against sum log(pdfs . pos)
(``drift.json`` in `--out`).
"""

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

from .profile_general import _device_ms

NBINS, NOBS = 50, 20_000
POP = dict(Niter=100, thin=400, mh_steps=3, seed=0, verbose=False)
HIER = dict(Niter=200, thin=5, seed=0, verbose=False)


def main(argv=None):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..kernels import build
    from ..kernels import pop as PK
    from ..samplers import hierarchical_sampler, population_sampler
    from ..samplers import population as TP

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--traces", action="store_true")
    ap.add_argument("--drift", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    build.load()

    rng = np.random.default_rng(0)
    grid = np.arange(NBINS)
    nz = np.exp(-0.5 * ((grid - 18) / 5.0) ** 2)
    nz /= nz.sum()
    c = rng.choice(NBINS, NOBS, p=nz) + rng.normal(0, 1.5, NOBS)
    pdfs = np.exp(-0.5 * ((grid[None] - c[:, None]) / 1.5) ** 2)
    pdfs /= pdfs.sum(1, keepdims=True)
    ps = population_sampler(pdfs, device="cuda")
    if args.drift:
        return _drift(ps, pdfs, args.drift, out_dir, card)
    hs = hierarchical_sampler(pdfs, device="cuda")

    def run(samp, kw):
        samp.reset()
        samp.run_mcmc(**kw)

    report = {"card": card}
    for name, call, count, units in (
            ("population_run_mcmc", lambda: run(ps, POP),
             POP["Niter"] * POP["thin"] * POP["mh_steps"], "proposals"),
            ("hierarchical_run_mcmc", lambda: run(hs, HIER),
             HIER["Niter"] * HIER["thin"], "sweeps")):
        call()
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        ops = sorted(((_device_ms(e), e.key, e.count)
                      for e in prof.key_averages()
                      if _device_ms(e) > 0 and not e.key.startswith("aten::")),
                     reverse=True)
        busy = sum(op[0] for op in ops)
        med = statistics.median(walls)
        print(f"== {name}: walls {walls} s, median {med} s = {count / med} "
              f"{units}/s; profiled wall {wall_ms} ms, device busy {busy} "
              f"ms, busy share {busy / wall_ms} | {card}", flush=True)
        for ms, key, n in ops[:10]:
            print(f"  {ms:10.3f} ms  {100 * ms / busy:6.2f}%  x{n}  "
                  f"{key[:90]}", flush=True)
        report[name] = dict(walls_s=walls, median_s=med,
                            profiled_wall_ms=wall_ms, device_busy_ms=busy,
                            ops=ops[:20])
        if args.traces:
            prof.export_chrome_trace(str(out_dir / f"trace_{name}.json"))

    # The kernel alone: proposals per step, then chains per launch.
    def kernel_ms(nchains, nsteps, mh, cluster=None):
        draws = ps._tables(0, nchains, nsteps, NBINS, mh).contiguous()
        start = ps._start(ps._resolve_pos0(None, nchains), TP._zero_prior,
                          True)
        times = []
        for _ in range(4):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            PK.pop_chain(draws, ps._pdfsT(), *start, thin=nsteps,
                         mh_steps=mh, cluster=cluster)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times[1:])

    def picked(nchains, mh):
        idx = torch.cuda.current_device()
        width = 2 + 2 * mh
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        return PK.choose_cluster(nchains, sms, {
            k: PK._active(idx, NOBS, width, mh, k)
            for k in PK.cluster_sizes(NOBS, width)})

    ps.reset()
    for route, cluster in (("default", None), ("block", 1)):
        by_mh = {mh: kernel_ms(1, 4_000, mh, cluster) for mh in (1, 2, 3, 4)}
        slope = (by_mh[4] - by_mh[1]) / 3 / 4_000 * 1e3
        k = picked(1, 3) if cluster is None else 1
        print(f"== pop_chain on the {route} route (cluster {k}), 1 chain x "
              f"4,000 steps, ms by mh_steps: {by_mh}; {slope} us per "
              f"proposal pass, {by_mh[1] / 4 - slope} us per step for the "
              f"gradient pass and the rest | {card}", flush=True)
        report[f"pop_chain_ms_by_mh_steps_{route}"] = by_mh
        report[f"pop_chain_cluster_{route}"] = k
    by_chains = {n: kernel_ms(n, 2_000, 3) for n in (1, 4, 32, 132, 264)}
    clusters = {n: picked(n, 3) for n in by_chains}
    print(f"== pop_chain, 2,000 steps x 3 proposals, ms by chains in one "
          f"launch: {by_chains}, cluster sizes {clusters} | {card}",
          flush=True)
    report["pop_chain_ms_by_chains"] = by_chains
    report["pop_chain_cluster_by_chains"] = clusters
    (out_dir / "profile_samplers.json").write_text(
        json.dumps(report, indent=1))


def _drift(ps, pdfs, mult, out_dir, card):
    """The carried overlap's drift over a chain `mult` times config 5's
    length, on both population routes."""
    import numpy as np
    import torch

    from ..kernels import pop as PK
    from ..samplers import population as TP

    nsteps = mult * POP["Niter"] * POP["thin"]
    draws = ps._tables(POP["seed"], 1, nsteps, NBINS,
                       POP["mh_steps"]).contiguous()
    start = ps._start(ps._resolve_pos0(None, 1), TP._zero_prior, True)
    report = {"card": card, "gibbs_steps": nsteps,
              "proposals": nsteps * POP["mh_steps"]}
    outs = {}
    for route, cluster in (("cluster", None), ("block", 1)):
        t0 = time.perf_counter()
        out = PK.pop_chain(draws, ps._pdfsT(), *start, thin=POP["thin"],
                           mh_steps=POP["mh_steps"], cluster=cluster)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs[route] = out
        samples = out[0][0].cpu().numpy().astype(float)
        pos = out[2][0].cpu().numpy().astype(float)
        ov = out[3][0].cpu().numpy().astype(float)
        ov64 = pdfs @ pos
        moved = int((np.abs(np.diff(samples, axis=0)).sum(axis=1) > 0).sum())
        report[route] = dict(
            wall_s=wall, drift=float(np.max(np.abs(ov - ov64) / ov64)),
            mean_drift=float(np.mean(np.abs(ov - ov64) / ov64)),
            lnpost_off=float(out[4][0]) - float(np.sum(np.log(ov64))),
            samples_moved=moved, samples=int(samples.shape[0]))
        print(f"== drift, {route} route: {nsteps} Gibbs steps in "
              f"{wall:.3f} s: max |ov - pdfs.pos| / ov "
              f"{report[route]['drift']:.4e} (mean "
              f"{report[route]['mean_drift']:.4e}), final lnpost "
              f"{report[route]['lnpost_off']:+.4f} from sum log(pdfs.pos) "
              f"in float64, {moved} of {samples.shape[0] - 1} thinned "
              f"samples moved | {card}", flush=True)
    report["routes_equal"] = all(
        torch.equal(a, b) for a, b in zip(outs["cluster"], outs["block"]))
    print(f"== drift: cluster and block routes bit-equal "
          f"{report['routes_equal']} | {card}", flush=True)
    (out_dir / "drift.json").write_text(json.dumps(report, indent=1))
    return 0 if report["routes_equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
