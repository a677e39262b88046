"""
Profiling / tracing hooks (port of `frankenz_tpu.utils.tracing`).

`trace` captures a `torch.profiler` trace (CPU activity, and the card's
kernels and copies when one is present) and writes it as a Chrome trace
(``.json``, viewable in Perfetto or ``chrome://tracing``); `span`
(and `annotate`, its JAX name) names a phase in it, and the fitter path
opens one at each layer boundary (`models/bruteforce.py`, `ops/fused.py`,
`ops/screen.py`; their counters go to `utils.metrics.metrics`);
`device_memory` reads the CUDA allocator's figures;
`collect_device_events` sums a trace's device events by name and
`profile_device_busy` takes their union, the busy time of PERF.md's
breakdowns (kernels + copies + memsets).

A span is a `torch.profiler.record_function` range while a profiler
records, so it sits on the profiler's clock beside the kernel and copy
events; otherwise it is one shared no-op context, which costs under a
microsecond (a `record_function` costs ~10 us even when nothing
records).

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

import functools
import glob
import json
import os
import time
from collections import Counter
from contextlib import contextmanager, nullcontext

import torch
import torch.autograd.profiler as _profiler

__all__ = ["trace", "span", "spanned", "annotate", "device_memory",
           "collect_device_events", "profile_device_busy",
           "DEVICE_CATEGORIES"]

# Chrome-trace categories of the work the card does (Kineto's names).
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# What `span` returns while no profiler records (reusable, stateless).
_OFF = nullcontext()


@contextmanager
def trace(logdir, create_perfetto_link=False):
    """Capture a `torch.profiler` trace of the enclosed block into `logdir`
    as one Chrome trace (``trace_<pid>_<ns>.json``): CPU activity on every
    thread (the fitter's store workers' spans too), and the card's when
    CUDA is available.  `create_perfetto_link` is kept for the JAX
    signature and ignored (the file opens in Perfetto)."""
    del create_perfetto_link
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def span(name):
    """A named range in the profiler's timeline while a profiler records
    (`torch.profiler.record_function`), else the shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


#: The JAX module's name for `span`.
annotate = span


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


def _kept_events(logdir, plane_filter):
    """The complete events (``"ph": "X"``) of the first Chrome trace
    (``.json``, sorted by path) under `logdir` whose category is one of
    `plane_filter` (a category or a tuple of them; "" keeps every
    complete event); None when no trace exists or it cannot be parsed."""
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
    return [ev for ev in events
            if isinstance(ev, dict) and ev.get("ph") == "X"
            and (cats == ("",) or ev.get("cat") in cats)]


def _by_name(events):
    """{name: seconds}, durations summed in the trace's microseconds and
    converted once."""
    out = Counter()
    for ev in events:
        out[ev.get("name", "")] += ev.get("dur", 0) or 0
    return {k: v / 1e6 for k, v in out.items()}


def _overlap_seconds(events):
    """Seconds in which two or more of `events` ran at once, counted once
    per extra event: each cluster of overlapping events' summed durations
    less its extent (0.0 exactly where no two overlap)."""
    over, group, lo, hi = 0.0, [], 0.0, 0.0
    for s, d in sorted((ev["ts"], ev.get("dur", 0) or 0)
                       for ev in events) + [(float("inf"), 0)]:
        if group and s >= hi:
            if len(group) > 1:
                over += sum(group) - (hi - lo)
            group = []
        if not group:
            lo, hi = s, s
        hi = max(hi, s + d)
        group.append(d)
    return over / 1e6


def collect_device_events(logdir, plane_filter=DEVICE_CATEGORIES):
    """Per-event summed durations (seconds) of the first Chrome trace
    (``.json``, sorted by path) under `logdir`.

    Sums the complete events (``"ph": "X"``) whose category is one of
    `plane_filter` (a category or a tuple of them; "" keeps every
    complete event).  Durations are summed in the trace's microseconds
    and converted once.  Returns {event_name: seconds}, or None when no
    trace exists or it cannot be parsed.
    """
    events = _kept_events(logdir, plane_filter)
    return None if events is None else _by_name(events)


def profile_device_busy(fn, args_list, prefix="",
                        plane_filter=DEVICE_CATEGORIES):
    """The card's busy time of `fn` under one `torch.profiler` trace.

    Runs ``fn(*args)`` for each tuple in `args_list`, synchronizes, and
    takes the union of the device events (kernels, copies, memsets) whose
    names start with `prefix`: work that overlaps on two streams counts
    once.  Returns ``(busy_seconds_per_call, events)``, `events` the
    per-event summed seconds, or (None, None) when the trace cannot be
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
        kept = _kept_events(logdir, plane_filter)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    events = None if kept is None else _by_name(kept)
    if not events:
        return None, None
    match = [ev for ev in kept if ev.get("name", "").startswith(prefix)]
    # Disjoint events give their plain sum, bit for bit.
    busy = (sum(v for k, v in events.items() if k.startswith(prefix))
            - _overlap_seconds(match))
    if busy <= 0:
        return None, events
    return busy / len(args_list), events
