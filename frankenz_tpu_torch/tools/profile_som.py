"""Wall times and one `torch.profiler` trace of config 3's SOM and GNG
halves, or their host halves against an earlier tree's, in turns.

    python -m frankenz_tpu_torch.tools.profile_som [--out DIR] [--reps N]
    python -m frankenz_tpu_torch.tools.profile_som --ref-tree DIR \
        [--out DIR] [--reps N]

Run from the root of a checkout on a machine with a CUDA card and
`nvcc`.  At config 3's widths (bench.py:164-215 without the GNG: 100,000
models over 5 filters from ``default_rng(0)``, a 50 x 50 map, 100,000
training steps with seed 1, 10,000 noisy objects on a 321-point grid in
2,048-object batches) it times `SelfOrganizingMap.train_network` (the
`som_train` kernel on the route its wrapper picks: a cluster at this
shape), `populate_network` and nodes-only `fit_predict`
(``save_fits=False``), then the same three for a `GrowingNeuralGas`
over the same models (bench.py:164-172, :201-209: 5,000 x 50 steps up
to 2,500 nodes, seed 2; `train_network` on the `gng_train` kernel, the
route its wrapper picks: a cluster at this shape):
one warm-up, `--reps` timed walls, then one run under the profiler.  It prints the walls, their median, the device busy
time (kernels and copies; `aten::` rows left out, as they repeat their
kernels' time) and its share of the profiled wall, and the heaviest
device operations, and writes ``profile_som.json`` and one Chrome trace
per phase to `--out` (default ``build/profile``).

With ``--ref-tree DIR`` it instead times the host halves (`populate_network`
and nodes-only `fit_predict` of both networks, each trained once) of the
`frankenz_tpu_torch` in DIR (an earlier commit's, e.g. ``git archive
<commit> frankenz_tpu_torch | tar -x -C build/ab/ref``; it builds its own
kernel library in its first process) against this checkout's, each tree in
its own process, in turns: earlier, this, this, earlier, one warm-up and
`--reps` walls a metric each (default 5; 3 gives 6 walls a tree).  It prints
the medians and every wall as one JSON line and writes it to
``DIR/profile_som_trees.json`` (`--out`).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

NMODEL, NFILT, NSIDE, NITER, NBATCH = 100_000, 5, 50, 2_000, 50
NFIT, BATCH, NGRID = 10_000, 2_048, 321
GNG_NITER, GNG_NODES, GNG_SEED = 5_000, 2_500, 2
HOST_METRICS = ("populate_network", "nodes_only_fit_predict",
                "gng_populate_network", "gng_nodes_only_fit_predict")


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _config3():
    """Config 3's networks, fit data and the phases [(name, call, units)]
    on the card, from whichever `frankenz_tpu_torch` the path holds."""
    import numpy as np
    import torch

    from frankenz_tpu_torch.models import GrowingNeuralGas, SelfOrganizingMap

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(0)
    f32 = np.float32
    m = rng.uniform(1, 10, (NMODEL, NFILT)).astype(f32)
    z = rng.uniform(0, 3, NMODEL)
    som = SelfOrganizingMap(m, (0.05 * m).astype(f32), np.ones_like(m),
                            device="cuda")
    gng = GrowingNeuralGas(m, (0.05 * m).astype(f32), np.ones_like(m),
                           device="cuda")
    d = (m[rng.integers(0, NMODEL, NFIT)]
         + rng.normal(0, 0.3, (NFIT, NFILT))).astype(f32)
    fit = (d, np.full_like(d, 0.3), np.ones_like(d), z,
           np.full(NMODEL, 0.05))
    fkw = dict(label_grid=np.linspace(0, 3.2, NGRID), nodes_only=True,
               verbose=False, batch_size=BATCH, save_fits=False)
    return [
        ("train_network", lambda: som.train_network(
            nside=NSIDE, nproj=2, niter=NITER, nbatch=NBATCH, seed=1,
            verbose=False), "steps"),
        ("populate_network",
         lambda: som.populate_network(verbose=False), "models"),
        ("nodes_only_fit_predict", lambda: som.fit_predict(*fit, **fkw),
         "objects"),
        ("gng_train_network", lambda: gng.train_network(
            niter=GNG_NITER, nbatch=NBATCH, max_nodes=GNG_NODES,
            seed=GNG_SEED, verbose=False), "gng_steps"),
        ("gng_populate_network",
         lambda: gng.populate_network(verbose=False), "models"),
        ("gng_nodes_only_fit_predict",
         lambda: gng.fit_predict(*fit, **fkw), "objects")]


def _walls(call, reps):
    """One warm-up, then `reps` walls of `call`, each ending on the card."""
    import torch

    call()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def _host_walls(reps):
    """The host halves' walls of the `frankenz_tpu_torch` on the path (the
    process of one tree): each network trained once, then every metric of
    HOST_METRICS timed in turn."""
    phases = _config3()
    for name, call, _ in phases:
        if name.endswith("train_network"):
            call()
    out = {name: _walls(call, reps) for name, call, _ in phases
           if name in HOST_METRICS}
    print("WALLS " + json.dumps(out), flush=True)


def _tree_walls(tree, who, reps):
    """`_host_walls` in its own process, importing the package in `tree`."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    code = ("import runpy, sys; sys.argv = ['profile_som']; m = "
            f"runpy.run_path({str(Path(__file__).resolve())!r}); "
            f"m['_host_walls']({int(reps)})")
    run = subprocess.run([sys.executable, "-c", code], cwd=str(tree),
                         env=env, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"walls in {tree} ({who}) failed:\n"
                           f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    line = [x for x in run.stdout.splitlines() if x.startswith("WALLS ")]
    return json.loads(line[-1][len("WALLS "):])


def _trees_main(args, card, out_dir):
    trees = {"ref": Path(args.ref_tree).resolve(), "new": Path.cwd()}
    walls = {"ref": [], "new": []}
    for who in ("ref", "new", "new", "ref"):
        walls[who].append(_tree_walls(trees[who], who, args.reps))
        print(f"{who}: {walls[who][-1]} | card {card}", flush=True)

    def every(runs, k):
        return [w for run in runs for w in run[k]]

    report = {"card": card, "ref_tree": str(trees["ref"]), "walls": walls,
              "median_s": {who: {k: statistics.median(every(runs, k))
                                 for k in HOST_METRICS}
                           for who, runs in walls.items()},
              "range_s": {who: {k: [min(every(runs, k)), max(every(runs, k))]
                                for k in HOST_METRICS}
                          for who, runs in walls.items()}}
    for k in HOST_METRICS:
        print(f"profile_som {k}: ref median {report['median_s']['ref'][k]} "
              f"{report['range_s']['ref'][k]}, new median "
              f"{report['median_s']['new'][k]} {report['range_s']['new'][k]}"
              f" | card {card}", flush=True)
    line = json.dumps(report)
    (out_dir / "profile_som_trees.json").write_text(line + "\n")
    print(line, flush=True)


def main(argv=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from frankenz_tpu_torch.kernels import build
    from frankenz_tpu_torch.tools.profile_general import _device_ms

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--ref-tree", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    card = _card()
    print(card, flush=True)
    if args.ref_tree is not None:
        return _trees_main(args, card, out_dir)
    build.load()

    report = {"card": card}
    for name, call, units in _config3():
        count = {"steps": NITER * NBATCH, "gng_steps": GNG_NITER * NBATCH,
                 "models": NMODEL, "objects": NFIT}[units]
        walls = _walls(call, args.reps)
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
        prof.export_chrome_trace(str(out_dir / f"trace_{name}.json"))
    (out_dir / "profile_som.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
