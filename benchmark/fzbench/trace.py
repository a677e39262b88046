"""The traced run: one `torch.profiler` window over the measured calls,
host spans around each call and its phases, and the reduction of the
trace to what the per-layer readers read.

The spans come from here, not from the program: each call sits in
``bench.call``, and for the traced run the program functions in `SPANS`
are wrapped in a `record_function` of the given name.  A function the
program no longer has cannot be wrapped, and a caller that imported one
by name calls it unwrapped: a traced run names on standard error the
spans it could not install and those that never showed in its trace, so
that a layer lost from the idle-gap attribution shows.  Busy time is the
union of the device's kernel, copy and memset intervals, so work that
overlaps on two streams counts once.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import tempfile
from collections import defaultdict

CALL_SPAN = "bench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")

# (module, attribute path, span name): the layers a call passes through.
SPANS = (
    ("frankenz_tpu_torch.models.bruteforce", "BruteForce._kernel_G",
     "fitter.kernel_G"),
    ("frankenz_tpu_torch.models.bruteforce", "BruteForce._stream",
     "fitter.stream"),
    ("frankenz_tpu_torch.parallel.mesh", "per_device", "fitter.stage"),
    ("frankenz_tpu_torch.models.bruteforce", "BruteForce._finish_shard",
     "fitter.finish_shard"),
    ("frankenz_tpu_torch.ops.fused", "model_bands", "fused.band_sort"),
    ("frankenz_tpu_torch.ops.fused", "fused_fit_pdf", "fused.fit_pdf"),
    ("frankenz_tpu_torch.ops.fused", "_table_route", "fused.table_route"),
    ("frankenz_tpu_torch.ops.screen", "screened", "screen.screened"),
    ("frankenz_tpu_torch.ops.screen", "sort_and_bound", "screen.seed"),
    ("frankenz_tpu_torch.ops.screen", "stack_gates", "screen.gates"),
)


def _wrap(fn, name):
    import torch

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapped


@contextlib.contextmanager
def program_spans(spans=SPANS):
    """Wrap the program functions of `spans` for the enclosed block;
    yields the list of the span names that could not be installed."""
    undo, missing = [], []
    try:
        for modname, attr, name in spans:
            try:
                owner = importlib.import_module(modname)
            except ImportError:
                missing.append(name)
                continue
            *path, leaf = attr.split(".")
            for p in path:
                owner = getattr(owner, p, None)
            if owner is None or not hasattr(owner, leaf):
                missing.append(name)
                continue
            raw = owner.__dict__.get(leaf, getattr(owner, leaf))
            if isinstance(raw, staticmethod):
                new = staticmethod(_wrap(raw.__func__, name))
            else:
                new = _wrap(raw, name)
            setattr(owner, leaf, new)
            undo.append((owner, leaf, raw))
        yield missing
    finally:
        for owner, leaf, raw in reversed(undo):
            setattr(owner, leaf, raw)


@contextlib.contextmanager
def profiled():
    """Profile the block (host and device); yields a list that holds the
    trace's events once the block has closed, and after them a dict
    ``{"spans_missing": [...]}``: the spans `program_spans` could not
    install."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    events = []
    with program_spans() as missing:
        with profile(activities=acts) as prof:
            yield events
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events.extend(e for e in json.load(f).get("traceEvents", [])
                          if e.get("ph") == "X")
        events.append({"spans_missing": list(missing)})
    finally:
        os.remove(path)


def union_length(intervals, lo=float("-inf"), hi=float("inf")):
    """Total length of the union of (start, end) intervals, clipped to
    [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The idle (start, end) stretches of [lo, hi] that no interval
    covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def innermost(host, points):
    """For each time in `points`, the name of the innermost host event
    (`host`: nested (start, end, name) sorted by start) that holds it, or
    "python" where none does."""
    names = [None] * len(points)
    stack, j = [], 0
    for i in sorted(range(len(points)), key=points.__getitem__):
        t = points[i]
        while j < len(host) and host[j][0] <= t:
            while stack and stack[-1][1] <= host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        names[i] = stack[-1][2] if stack else "python"
    return names


def short(name, width=120):
    """A device operation's name, its template and argument lists cut to
    `width` characters."""
    return name if len(name) <= width else name[:width - 3] + "..."


def summarize(events, top=10):
    """The trace reduced to what the readers need: the window (first
    call's start to last call's end), and per device the busy time
    (union), kernel time and count, and device-to-host copy time; the
    heaviest device operations and the idle stretches by what the host
    was doing (mean over the devices), seconds; the spans of `SPANS` not
    installed (``spans_missing``) and installed but never in the trace
    (``spans_unseen``: off this cell's route, or called by a name that
    was imported before the wrap)."""
    missing = next((e["spans_missing"] for e in events
                    if "spans_missing" in e), [])
    calls = [e for e in events if e.get("name") == CALL_SPAN
             and e.get("cat") == "user_annotation"]
    if not calls:
        return None
    seen = {e.get("name") for e in events
            if e.get("cat") == "user_annotation"}
    lo = min(e["ts"] for e in calls)
    hi = max(e["ts"] + e["dur"] for e in calls)
    main_tid = calls[0].get("tid")
    per = defaultdict(lambda: dict(intervals=[], kernel_s=0.0, kernel_n=0,
                                   dtoh_s=0.0, copy_s=0.0, memset_s=0.0))
    ops = defaultdict(float)
    for e in events:
        cat = e.get("cat")
        if cat not in DEVICE_CATS:
            continue
        s, d = e["ts"], e.get("dur", 0.0)
        if s < lo or s + d > hi:
            continue
        dev = int((e.get("args") or {}).get("device", e.get("pid", 0)))
        rec = per[dev]
        rec["intervals"].append((s, s + d))
        sec = d * 1e-6
        ops[short(e.get("name", cat))] += sec
        if cat == "kernel":
            rec["kernel_s"] += sec
            rec["kernel_n"] += 1
        elif cat == "gpu_memcpy":
            rec["copy_s"] += sec
            if "DtoH" in e.get("name", ""):
                rec["dtoh_s"] += sec
        else:
            rec["memset_s"] += sec
    host = sorted(((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
                   for e in events if e.get("cat") in HOST_CATS
                   and e.get("tid") == main_tid),
                  key=lambda h: (h[0], -h[1]))
    idle = defaultdict(float)
    devices = {}
    for dev, rec in sorted(per.items()):
        busy = union_length(rec["intervals"], lo, hi) * 1e-6
        stretch = gaps(rec["intervals"], lo, hi)
        for (s, e), name in zip(stretch, innermost(
                host, [0.5 * (s + e) for s, e in stretch])):
            idle[name] += (e - s) * 1e-6 / len(per)
        devices[dev] = dict(busy_s=busy, kernel_s=rec["kernel_s"],
                            kernel_n=rec["kernel_n"], dtoh_s=rec["dtoh_s"],
                            copy_s=rec["copy_s"], memset_s=rec["memset_s"])
    return dict(window_s=(hi - lo) * 1e-6, calls=len(calls),
                devices=devices, spans_missing=missing,
                spans_unseen=[n for *_, n in SPANS
                              if n not in missing and n not in seen],
                device_ops=sorted(ops.items(), key=lambda kv: -kv[1])[:top],
                idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:top])
