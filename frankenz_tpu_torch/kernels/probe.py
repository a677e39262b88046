"""The thread-block cluster probe (``csrc/cluster_probe.cu``).

`cluster_probe` times, on the card, what the cluster routes of the two
chain kernels (`gng_train`, `pop_chain`) pay for each exchange: one
cluster barrier round, one load from another CTA's shared memory (DSMEM),
and the two together in a dependent loop as the chains run them, for
cluster sizes K = 2, 4, 8 and 16, with the card's count of such clusters
held at once.  It is a measurement, not a step of any computation: it has
no plain version and no launch count, and it needs a CUDA device.
"""

from __future__ import annotations

import torch

from . import build as _build

__all__ = ["cluster_probe", "MODES"]

MODES = ("barrier", "dsmem_load", "exchange")


def cluster_probe(device="cuda", sizes=(2, 4, 8, 16), iters=40_000, reps=3):
    """{K: {"max_active": clusters of the probe the card holds at once (0:
    it cannot schedule K; negative: minus the query's CUDA error), and for
    each mode of MODES "<mode>_cycles" (clock64 cycles a round, CTA 0's
    loop, median of `reps` launches) and "<mode>_ns" (CUDA events around
    the launch over `iters` rounds, median)}}.  Sizes the card cannot
    schedule are not launched."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("cluster_probe needs a CUDA device")
    lib = _build.load()
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.float32, device=dev)
    out = {}
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k in sizes:
            n = lib.fz_cluster_probe_max_active(int(k))
            row = {"max_active": n}
            out[int(k)] = row
            if n < 1:
                continue
            for mode, name in enumerate(MODES):
                cyc, ns = [], []
                for _ in range(reps + 1):  # the first launch warms up
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    rc = lib.fz_cluster_probe(int(k), mode, int(iters),
                                              cycles.data_ptr(),
                                              sink.data_ptr(), stream)
                    b.record()
                    if rc != 0:
                        raise RuntimeError(f"cluster_probe K={k} mode "
                                           f"{name} failed: CUDA error {rc}")
                    b.synchronize()
                    cyc.append(int(cycles.item()) / iters)
                    ns.append(a.elapsed_time(b) * 1e6 / iters)
                row[f"{name}_cycles"] = sorted(cyc[1:])[reps // 2]
                row[f"{name}_ns"] = sorted(ns[1:])[reps // 2]
    return out
