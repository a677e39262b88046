"""The program's spans in a traced window: host seconds by span name, and
the device's idle seconds by the innermost span.

`trace.summarize` charges each idle stretch of the card to the innermost
host event of any kind, so a stretch inside a pageable copy goes to
``aten::copy_`` or ``cudaMemcpyAsync``, which name no part of the
program.  Here only ``user_annotation`` ranges count: ``bench.call``,
the wrappers of `trace.SPANS`, and the spans the program opens itself
(`frankenz_tpu_torch.utils.tracing.span`), so the same stretch goes to
the program's ``readback.copy``.  A wrapper and a program span of one
name nest; a name's seconds are the union of its ranges, so they count
once.  The window, the thread and the devices are `trace.summarize`'s:
the calls' first start to last end, the calls' thread, every device that
ran a kernel, copy or memset inside the window.
"""

from __future__ import annotations

from collections import defaultdict

from . import trace as tr

USER = "user_annotation"


def window(events):
    """(lo, hi, tid) of the traced calls, microseconds; None without a
    call."""
    calls = [e for e in events if e.get("name") == tr.CALL_SPAN
             and e.get("cat") == USER]
    if not calls:
        return None
    return (min(e["ts"] for e in calls),
            max(e["ts"] + e["dur"] for e in calls), calls[0].get("tid"))


def _user(events, tid):
    return [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
            for e in events if e.get("cat") == USER and e.get("tid") == tid]


def span_seconds(events):
    """{name: (host seconds, count)} of every span on the calls' thread,
    clipped to the window: the union of the name's ranges, and the number
    of its ranges that no other range of the name holds or overlaps."""
    win = window(events)
    if win is None:
        return {}
    lo, hi, tid = win
    by = defaultdict(list)
    for s, e, name in _user(events, tid):
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by[name].append((s, e))
    out = {}
    for name, iv in by.items():
        total, n, cur = 0.0, 0, None
        for s, e in sorted(iv):
            if cur is not None and s < cur[1]:
                cur[1] = max(cur[1], e)
                continue
            if cur is not None:
                total += cur[1] - cur[0]
            cur, n = [s, e], n + 1
        total += cur[1] - cur[0]
        out[name] = (total * 1e-6, n)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def idle_by_span(events):
    """{name: seconds}: the card's idle stretches inside the window, each
    charged to the innermost span (on the calls' thread) that holds its
    midpoint, "python" where none does, mean over the devices; every
    name, so the values sum to the mean idle time."""
    win = window(events)
    if win is None:
        return {}
    lo, hi, tid = win
    per = defaultdict(list)
    for e in events:
        if e.get("cat") not in tr.DEVICE_CATS:
            continue
        s, d = e["ts"], e.get("dur", 0.0)
        if s < lo or s + d > hi:
            continue
        dev = int((e.get("args") or {}).get("device", e.get("pid", 0)))
        per[dev].append((s, s + d))
    host = sorted(_user(events, tid), key=lambda h: (h[0], -h[1]))
    idle = defaultdict(float)
    for iv in per.values():
        stretch = tr.gaps(iv, lo, hi)
        for (s, e), name in zip(stretch, tr.innermost(
                host, [0.5 * (s + e) for s, e in stretch])):
            idle[name] += (e - s) * 1e-6 / len(per)
    return dict(sorted(idle.items(), key=lambda kv: -kv[1]))


def counter_change(before, after):
    """The counters that moved between two snapshots of a registry's
    ``counters``: {name: after - before}."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}
