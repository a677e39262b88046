#!/usr/bin/env python3
"""Readings that the output check's limits are set from (not part of a
benchmark run).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --seconds 3 [--out file.json]

In one process, for each seed: the cell's set-up and a short window at
its own load (the same number of sampled answers as a run), the program's
numbers against the reference; and for each control seed the control's:
the reference itself, computed in TF32, put in the program's place on the
same rows.  Prints one JSON line a seed and the largest and smallest
reading of each number.  Needs the cell's cards, as `run.py` does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from fzbench import cell as cl  # noqa: E402
from fzbench import compare, spec  # noqa: E402
from fzbench.reference import Arith  # noqa: E402


def control_readings(c, seed, device, kept):
    """The control's numbers on the sampled rows of a run (`kept`)."""
    ctl, _ = cl.reference_rows(c, seed, device, kept["sample"],
                               arith=Arith("tf32"), flip_band=0.0)
    return compare.readings((ctl["pdf"], ctl["lmap"], ctl["levid"]),
                            kept["ref"])


def calibrate(c, seeds, control_seeds, seconds, device="cuda",
              log=sys.stdout):
    rows = []
    for seed in seeds + [s for s in control_seeds if s not in seeds]:
        kept = {}
        t = time.perf_counter()
        res = cl.run(c, seed, seconds, device=device, t0=t, keep=kept)
        row = {"seed": seed, "program": {k: v["value"] for k, v in
                                         res["checks"].items()},
               "correct": res["correct"], "attempted": kept["attempted"],
               "rate": kept["rate"], "setup_s": kept["setup_s"],
               "rows": int(len(kept["sample"].lmap)),
               "rows_near_cut": int((kept["ref"]["near"] > 0).sum()),
               "kept_mean": float(kept["ref"]["kept"].mean()),
               "sweeps_mean": float(kept["ref"]["sweeps"].mean())}
        if seed in control_seeds:
            row["control"] = control_readings(c, seed, device, kept)
        rows.append(row)
        print(json.dumps(row), file=log, flush=True)
    summary = {"workload": c.name, "limits": c.limits}
    for side in ("program", "control"):
        for k in compare.CHECKS:
            vals = [r[side][k] for r in rows if side in r]
            if vals:
                summary[f"{side}_{k}"] = {
                    "max": max(vals), "min": min(vals), "n": len(vals)}
    return rows, summary


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, required=True)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    c = spec.Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < c.chips:
        print(f"{args.workload} needs {c.chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    rows, summary = calibrate(c, args.seeds, args.control_seeds,
                              args.seconds)
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
