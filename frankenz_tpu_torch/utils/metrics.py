"""
Structured metrics and throughput telemetry.

Port of `frankenz_tpu.utils.metrics`: a counter/timer registry that
serializes to JSON lines (chi^2 pair-evals/s, PDF stacks/s, wall-clock
per phase).  The one difference is `Metrics.timer` with ``cuda=True``:
PyTorch returns before the card finishes, so the timer calls
`torch.cuda.synchronize()` before each clock read and the phase time is
the device's, not the enqueue's.
"""

from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager

import torch

__all__ = ["Metrics", "metrics", "timed"]


class Metrics:
    """A tiny counter/timer registry with JSON-line export."""

    def __init__(self):
        self.counters = {}
        self.timings = {}

    def count(self, name, value=1):
        self.counters[name] = self.counters.get(name, 0) + value

    def observe(self, name, seconds):
        agg = self.timings.setdefault(name, {"n": 0, "total_s": 0.0,
                                             "max_s": 0.0})
        agg["n"] += 1
        agg["total_s"] += seconds
        agg["max_s"] = max(agg["max_s"], seconds)

    def rate(self, counter, timer):
        """counter / total timer seconds (e.g. pair-evals per second)."""
        t = self.timings.get(timer, {}).get("total_s", 0.0)
        return self.counters.get(counter, 0) / t if t > 0 else 0.0

    @contextmanager
    def timer(self, name, items=None, item_counter=None, cuda=False):
        """Time the block; with ``cuda=True`` synchronize the card before
        both clock reads so queued kernels are inside the phase."""
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
            self.observe(name, time.perf_counter() - t0)
            if items is not None and item_counter is not None:
                self.count(item_counter, items)

    def snapshot(self):
        return {"counters": dict(self.counters),
                "timings": {k: dict(v) for k, v in self.timings.items()}}

    def emit(self, stream=None):
        """Write one JSON line with the current snapshot."""
        (stream or sys.stderr).write(json.dumps(self.snapshot()) + "\n")

    def reset(self):
        self.counters.clear()
        self.timings.clear()


#: Process-global default registry.
metrics = Metrics()


@contextmanager
def timed(name, registry=None):
    """Convenience timer against the global registry."""
    reg = registry or metrics
    with reg.timer(name):
        yield
