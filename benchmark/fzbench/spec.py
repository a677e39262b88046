"""What a cell is: `BENCHMARK.json`'s entries and the files they name.

Everything that belongs to one configuration, one cell or one metric is a
file of its own, found by its name:

* ``configs/<config>.json``: the deployment (models, grid, catalog, fit);
* ``workloads/<cell>.json``: the traffic parameters and the limits of the
  output check;
* ``metrics/<metric>.py``: a reader, ``read(ctx) -> float | None``, for
  every metric whose name is ``<metric>`` or starts with ``<metric>.``;
* ``counts/<route>.py``: the work a call needs, for the roofline.

A later change adds a cell, a configuration or a metric by adding files
and `BENCHMARK.json` entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    """`BENCHMARK.json` at the root of the checkout."""
    return load_json(Path(root) / "BENCHMARK.json")


def workload_entry(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench, name):
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def applies(metric, bench, cell):
    """Whether `metric` (an entry of `end_to_end` or `per_layer`) is
    reported in `cell`: listed there, or, without a ``workloads`` key,
    in every cell that reports the metric it moves (an end-to-end
    metric without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    target = next(m for m in bench["end_to_end"] if m["name"] == moves)
    return applies(target, bench, cell)


def cell_metrics(bench, cell, kind):
    """The `kind` ("end_to_end" or "per_layer") metrics of `cell`."""
    return [m for m in bench[kind] if applies(m, bench, cell)]


class Cell:
    """One cell: its `BENCHMARK.json` entry, its workload file and its
    configuration file, merged into the numbers a run needs."""

    def __init__(self, name, bench=None, bench_dir=BENCH_DIR):
        bench = benchmark() if bench is None else bench
        self.bench = bench
        self.name = name
        self.entry = workload_entry(bench, name)
        self.bench_dir = Path(bench_dir)
        self.workload = load_json(self.bench_dir / "workloads"
                                  / f"{name}.json")
        self.config = load_json(ROOT / config_entry(
            bench, self.entry["config"])["file"])
        for key in ("config", "chips"):
            if self.workload[key] != self.entry[key]:
                raise ValueError(
                    f"workloads/{name}.json says {key}="
                    f"{self.workload[key]!r}, BENCHMARK.json "
                    f"{self.entry[key]!r}")
        self.chips = int(self.entry["chips"])
        self.traffic = self.workload["traffic"]
        self.limits = self.workload["limits"]
        self.end_to_end = cell_metrics(bench, name, "end_to_end")
        self.per_layer = cell_metrics(bench, name, "per_layer")


def load_module(path, name):
    """The Python file at `path` as a module named `name` (reader and
    count files are found by name, not imported as a package)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name, bench_dir=BENCH_DIR):
    """``read`` of `metrics/<base>.py`, the base the metric's name up to
    its first dot: one reader serves ``kernel_ms`` and ``kernel_ms.free``
    (`BENCHMARK.json`'s ``workloads`` say which cells report each)."""
    base = metric_name.split(".")[0]
    path = Path(bench_dir) / "metrics" / f"{base}.py"
    return load_module(path, "fzbench_metric_" + base).read


def counter(route, bench_dir=BENCH_DIR):
    """`counts/<route>.py`'s ``count``."""
    path = Path(bench_dir) / "counts" / f"{route}.py"
    return load_module(path, "fzbench_count_" + route).count
