"""Shared set-up of the benchmark's CPU tests: the harness on the path,
and cells cut to a size a test run holds (the CPU runs the port's plain
versions of its kernels)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from fzbench import spec  # noqa: E402

TINY_MODELS = 2_000


def tiny_cell(name, objects=512, batch=256, sample=128):
    """Cell `name` with few models and objects, for the CPU."""
    c = spec.Cell(name)
    c.config["models"]["n"] = TINY_MODELS
    c.traffic.update(objects_per_call=objects, batch_size=batch,
                     sample_rows=sample)
    return c
