#!/usr/bin/env python3
"""Where a cell's device-idle time falls among the program's own spans.

    python3 benchmark/span_split.py --workload <cell> --seed <n> \\
        --seconds <s> [--out <file.json>]

From the root of a checkout, on the cards the cell asks for.  Set-up as
`run.py`'s (the inputs from the seed, the fitter, one warm call), then
one `torch.profiler` window of `--seconds` over the calls, as the traced
run's (`trace.profiled`, `trace.SPANS` wrapped), reduced twice: by
`trace.summarize` (``idle_gaps``: idle seconds by the innermost host
event of any kind, the result line's breakdown) and by `fzbench.spans`
(``spans``: host seconds and count by span name; ``idle_by_span``: idle
seconds by the innermost span), with the counters of
`frankenz_tpu_torch.utils.metrics.metrics` that moved over the window.
Seconds and counts are the window's totals; ``calls`` divides them.
Prints one JSON line, and writes it to `--out`.  The output check is not
made here: `run.py` makes it.
"""

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def split(c, seed, seconds, device="cuda"):
    """The split of one window of cell `c` (a `spec.Cell`), as a dict."""
    import torch

    from fzbench import cell, spans
    from fzbench import trace as tr
    from fzbench import traffic as tf
    from fzbench.window import Window
    from frankenz_tpu_torch.utils.metrics import metrics

    torch.backends.cuda.matmul.allow_tf32 = False
    devices = cell._devices(torch, device, int(c.traffic.get("mesh", 1)))
    dep = tf.Deployment(c.config, c.traffic, seed, devices[0])
    prog = cell.Program(c, dep, devices)
    prog.call(0)
    cell._sync(torch, devices)
    win = Window(seconds)

    def timed(k):
        with torch.profiler.record_function(tr.CALL_SPAN):
            return prog.call(k)

    before = dict(metrics.counters)
    with tr.profiled() as events:
        win.run(timed)
    moved = spans.counter_change(before, metrics.counters)
    summary = tr.summarize(events)
    return dict(
        cell=c.name, seed=seed, calls=summary["calls"],
        failed=win.failed, errors=win.errors[:3],
        objects_per_s=win.rate, window_s=summary["window_s"],
        busy_s={str(d): v["busy_s"] for d, v in
                summary["devices"].items()},
        dtoh_s={str(d): v["dtoh_s"] for d, v in
                summary["devices"].items()},
        idle_gaps=summary["idle_gaps"],
        spans_unseen=summary["spans_unseen"],
        spans=spans.span_seconds(events),
        idle_by_span=spans.idle_by_span(events),
        counters=moved)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import run

    run._caches()
    from fzbench import spec

    got = split(spec.Cell(args.workload), args.seed, args.seconds)
    line = json.dumps(got)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0 if got["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
