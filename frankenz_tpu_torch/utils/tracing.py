"""
Profiling / tracing hooks (port of `frankenz_tpu.utils.tracing`).

`trace` captures a `torch.profiler` trace (CPU activity, and the card's
kernels and copies when one is present) and writes it as a Chrome trace
(``.json``, viewable in Perfetto or ``chrome://tracing``); `annotate`
names a phase in it; `device_memory` reads the CUDA allocator's figures;
`collect_device_events` and `profile_device_busy` sum a trace's device
events, the busy time of PERF.md's breakdowns (kernels + copies, as
`tools/profile_general.py` sums them).

Where the JAX module parses an xplane, this one parses the Chrome trace,
so two arguments change meaning (the defaults keep the JAX module's
intent):

* ``plane_filter``: JAX keeps the events of every device plane whose
  name holds it ("TPU").  Here it is the Chrome-trace categories whose
  events are kept (`DEVICE_CATEGORIES`: kernels, copies and memsets on
  the card; "" keeps every complete event).
* ``prefix``: JAX sums the events of compiled XLA modules ("jit_").  A
  PyTorch trace has no module events; each kernel and copy is its own
  event, so the default "" sums every kept event, and a prefix keeps
  the kernels whose names start with it.
"""

from __future__ import annotations

import glob
import json
import os
import time
from collections import Counter
from contextlib import contextmanager

import torch

__all__ = ["trace", "annotate", "device_memory", "collect_device_events",
           "profile_device_busy", "DEVICE_CATEGORIES"]

# Chrome-trace categories of the work the card does (Kineto's names).
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextmanager
def trace(logdir, create_perfetto_link=False):
    """Capture a `torch.profiler` trace of the enclosed block into `logdir`
    as one Chrome trace (``trace_<pid>_<ns>.json``): CPU activity, and
    the card's when CUDA is available.  `create_perfetto_link` is kept
    for the JAX signature and ignored (the file opens in Perfetto)."""
    del create_perfetto_link
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name):
    """Named annotation context (a range in the profiler's timeline)."""
    return torch.profiler.record_function(name)


def device_memory(device=None):
    """The card's allocator figures under the JAX module's keys
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``); {} on the
    CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    try:
        return {"bytes_in_use": int(torch.cuda.memory_allocated(device)),
                "peak_bytes_in_use": int(
                    torch.cuda.max_memory_allocated(device)),
                "bytes_limit": int(torch.cuda.get_device_properties(
                    device).total_memory)}
    except Exception:
        return {}


def collect_device_events(logdir, plane_filter=DEVICE_CATEGORIES):
    """Per-event summed durations (seconds) of the first Chrome trace
    (``.json``, sorted by path) under `logdir`.

    Sums the complete events (``"ph": "X"``) whose category is one of
    `plane_filter` (a category or a tuple of them; "" keeps every
    complete event).  Durations are summed in the trace's microseconds
    and converted once.  Returns {event_name: seconds}, or None when no
    trace exists or it cannot be parsed.
    """
    files = sorted(glob.glob(os.path.join(logdir, "**", "*.json"),
                             recursive=True))
    if not files:
        return None
    try:
        with open(files[0]) as f:
            events = json.load(f)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
    except (OSError, ValueError):
        return None
    cats = ((plane_filter,) if isinstance(plane_filter, str)
            else tuple(plane_filter))
    out = Counter()
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        if cats != ("",) and ev.get("cat") not in cats:
            continue
        out[ev.get("name", "")] += ev.get("dur", 0) or 0
    return {k: v / 1e6 for k, v in out.items()}


def profile_device_busy(fn, args_list, prefix="",
                        plane_filter=DEVICE_CATEGORIES):
    """The card's busy time of `fn` under one `torch.profiler` trace.

    Runs ``fn(*args)`` for each tuple in `args_list`, synchronizes, and
    sums the device events (kernels, copies, memsets) whose names start
    with `prefix`.  Returns ``(busy_seconds_per_call, events)``, `events`
    the per-event seconds, or (None, None) when the trace cannot be
    captured or parsed or holds no device event, and (None, events) when
    no kept event matches `prefix`.
    """
    import shutil
    import tempfile

    logdir = tempfile.mkdtemp(prefix="fz_trace_")
    try:
        try:
            with trace(logdir):
                for args in args_list:
                    fn(*args)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        except Exception:
            return None, None
        events = collect_device_events(logdir, plane_filter=plane_filter)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    if not events:
        return None, None
    busy = sum(v for k, v in events.items() if k.startswith(prefix))
    if busy <= 0:
        return None, events
    return busy / len(args_list), events
