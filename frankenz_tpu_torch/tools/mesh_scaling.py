"""`BruteForce.fit_predict(mesh=)` over distinct cards against one card.

    python -m frankenz_tpu_torch.tools.mesh_scaling [--out DIR] [--reps N]
        [--nobj N] [--nmodel M] [--cpu]

Run from the root of a checkout on a machine with two or more CUDA cards
and `nvcc`.  Config 4 at full width (chip_smoke.py's generator,
bench.py:304-332: 100,000 models x 5 filters, a 301-point grid, 131,072
objects in batches of 65,536), fully observed and with 15% of the bands
missing.  For each, it times `fit_predict` (host arrays out; a warm-up,
then the median of `--reps` walls) on one card, on a mesh of that card
repeated once a card (``make_mesh(devices=[cuda:0] * n)``) and on the
mesh of the n distinct cards (``make_mesh()``), and requires the
distinct cards' results equal to the repeated card's bit for bit (the
same shards through the same kernels).  It prints each card's name and
power limit and one JSON line, also written to ``DIR/mesh_scaling.json``.
``--cpu`` runs the same on ``["cpu"] * 4`` at a small size: a dry run of
the script on the kernels' plain versions.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

NFILT, NGRID, P_MISSING = 5, 301, 0.15


def card_lines():
    """`nvidia-smi`'s name and power limit of each card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def config4(nobj, nmodel):
    """chip_smoke.py's config-4 inputs: models, errors, labels, the PDF
    dictionary, the catalog, its errors and both masks."""
    from frankenz_tpu_torch.ops import kde as TK

    rng = np.random.default_rng(0)
    f32 = np.float32
    models = rng.uniform(1, 10, (nmodel, NFILT)).astype(f32)
    zlabels = rng.uniform(0, 3.5, nmodel)
    pdict = TK.PDFDict(np.linspace(0.0, 4.0, NGRID),
                       np.linspace(0.01, 0.5, 100))
    data = rng.uniform(1, 10, (nobj, NFILT)).astype(f32)
    masks = {"full": np.ones((nobj, NFILT), f32),
             "masked": (np.random.default_rng(2).uniform(
                 size=(nobj, NFILT)) >= P_MISSING).astype(f32)}
    return (models, (0.05 * models).astype(f32), zlabels,
            np.full(nmodel, 0.1), pdict, data,
            np.full((nobj, NFILT), 0.25, f32), masks)


def wall(fn, reps, sync):
    """A warm-up call, then the median wall of `reps` calls, and the last
    call's output."""
    out = fn()
    walls = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        out = fn()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), out


def same(a, b):
    return all(np.array_equal(x, y, equal_nan=True) for x, y in
               zip((a[0],) + tuple(a[1]), (b[0],) + tuple(b[1])))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="build/mesh_scaling")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--nobj", type=int, default=131_072)
    p.add_argument("--nmodel", type=int, default=100_000)
    p.add_argument("--batch", type=int, default=65_536)
    p.add_argument("--cpu", action="store_true")
    a = p.parse_args(argv)

    from frankenz_tpu_torch import parallel as PL
    from frankenz_tpu_torch.models import BruteForce

    if a.cpu:
        devices, sync = [torch.device("cpu")] * 4, (lambda: None)
    else:
        if torch.cuda.device_count() < 2:
            print("mesh_scaling: needs two or more CUDA cards",
                  file=sys.stderr)
            return 1
        from frankenz_tpu_torch.kernels import build as kbuild

        kbuild.build()
        kbuild.load()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        sync = torch.cuda.synchronize
    cards = card_lines()
    for line in cards:
        print(f"card: {line}", flush=True)
    (models, models_err, zlabels, zerrs, pdict, data, data_err,
     masks) = config4(a.nobj, a.nmodel)
    bf = BruteForce(models, models_err, np.ones_like(models),
                    device=devices[0])
    n = len(devices)
    meshes = {"one": None,
              "repeated": PL.make_mesh(devices=[devices[0]] * n),
              "distinct": PL.make_mesh(devices=devices)}
    kw = dict(label_dict=pdict, verbose=False, return_gof=True,
              batch_size=a.batch)
    results = {}
    for label, mask in masks.items():
        row, outs = {}, {}
        for name, mesh in meshes.items():
            row[f"{name}_s"], outs[name] = wall(
                lambda: bf.fit_predict(data, data_err, mask, zlabels, zerrs,
                                       mesh=mesh, **kw), a.reps, sync)
        row["distinct_speedup"] = row["one_s"] / row["distinct_s"]
        row["distinct_bitwise_repeated"] = same(outs["distinct"],
                                                outs["repeated"])
        results[label] = row
        print(f"mesh_scaling {label}: {a.nobj} x {a.nmodel} x {NGRID}, "
              f"batch {a.batch}: one card {row['one_s']:.4f} s, {n} shards "
              f"of one card {row['repeated_s']:.4f} s, {n} cards "
              f"{row['distinct_s']:.4f} s ({row['distinct_speedup']:.2f}x "
              f"one card); {n} cards bit for bit the repeated card "
              f"{row['distinct_bitwise_repeated']} | cards {cards}",
              flush=True)
    line = json.dumps({"cards": cards, "devices": [str(d) for d in devices],
                       "nobj": a.nobj, "nmodel": a.nmodel,
                       "batch": a.batch, "reps": a.reps,
                       "results": results})
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "mesh_scaling.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0 if all(r["distinct_bitwise_repeated"]
                    for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
