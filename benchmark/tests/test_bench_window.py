"""The window's arithmetic: the rate over the window, the sample of
answers, and the trace's union of intervals, idle stretches and host
attribution."""

import numpy as np
import pytest

import bench_util  # noqa: F401
from fzbench import layers, trace, window


def test_window_rate_is_all_objects_over_the_span():
    # Three calls, 100 objects each, with a 0.5 s gap between two: the
    # rate counts the gap (all the time), not a median of per-call rates.
    starts, ends = [0.0, 1.0, 2.5], [1.0, 2.0, 3.5]
    assert window.window_rate([100, 100, 100], starts, ends) == \
        pytest.approx(300 / 3.5)
    assert window.window_rate([], [], []) is None


def test_window_runs_until_seconds_and_counts_failures():
    t = [0.0]

    def clock():
        return t[0]

    def call(k):
        t[0] += 0.4
        if k == 2:
            raise RuntimeError("lost")
        return ("out", (None, None)), 10

    w = window.Window(1.0)
    w.run(call, clock=clock)
    # Calls at 0.0, 0.4, 0.8 (fails), the third ends at 1.2 >= 1.0.
    assert w.attempted == 3 and w.failed == 1
    assert w.objects == [10, 10, 0]
    assert w.rate == pytest.approx(20 / 1.2)


def test_sample_keeps_the_smallest_keys_over_all_calls():
    s = window.Sample(seed=7, size=16)
    outs = []
    for call in range(5):
        n = 40
        pdf = np.arange(n * 3, dtype=np.float32).reshape(n, 3) + 1000 * call
        lmap = np.full(n, call, np.float32)
        outs.append((pdf, lmap))
        s.add(call, call % 2, (pdf, (lmap, lmap + 1)))
    keys = np.concatenate([window.traffic.sample_keys(7, c, 40)
                           for c in range(5)])
    want = np.sort(keys)[:16]
    np.testing.assert_array_equal(np.sort(s.keys), want)
    for (chunk, row), pdf, lm in zip(s.where, s.pdf, s.lmap):
        call = int(lm)
        assert chunk == call % 2
        np.testing.assert_array_equal(pdf, outs[call][0][row])
    pos, rows = s.rows_of(1)
    assert np.all(s.where[pos, 0] == 1) and len(pos) == len(rows)


def test_union_counts_overlap_once():
    # Two streams overlapping: [0, 4] and [2, 6] and a separate [8, 9].
    iv = [(0, 4), (2, 6), (8, 9)]
    assert trace.union_length(iv) == 7
    assert trace.union_length(iv, 1, 8.5) == 5.5
    assert trace.gaps(iv, 0, 10) == [(6, 8), (9, 10)]


def test_innermost_host_event():
    host = [(0, 10, "call"), (1, 4, "stream"), (2, 3, "copy"),
            (5, 9, "finish")]
    assert trace.innermost(host, [2.5, 3.5, 4.5, 6, 11]) == \
        ["copy", "stream", "call", "finish", "python"]


def _ev(cat, name, ts, dur, dev=0, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": dev, "args": {"device": dev}}


def test_summarize_and_readers():
    ev = [_ev("user_annotation", trace.CALL_SPAN, 0, 100),
          _ev("user_annotation", trace.CALL_SPAN, 100, 100),
          _ev("cpu_op", "aten::copy_", 150, 40),
          _ev("kernel", "k1", 10, 30), _ev("kernel", "k2", 20, 30),
          _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 150, 40),
          _ev("gpu_memset", "Memset", 60, 10)]
    s = trace.summarize(ev)
    assert s["calls"] == 2 and s["window_s"] == pytest.approx(200e-6)
    d = s["devices"][0]
    # Kernels overlap on [20, 40]: busy = [10, 50] + [60, 70] + [150, 190].
    assert d["busy_s"] == pytest.approx(90e-6)
    assert d["kernel_s"] == pytest.approx(60e-6) and d["kernel_n"] == 2
    assert d["dtoh_s"] == pytest.approx(40e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["bench.call"] == pytest.approx(110e-6)
    assert s["spans_missing"] == []
    assert s["spans_unseen"] == [name for *_, name in trace.SPANS]
    ctx = layers.Context(123.0, 4.0, trace=s, least_s=15e-6)
    assert ctx.per_call("kernel_n") == 1.0
    assert ctx.idle_shares() == [pytest.approx(55.0)]
    assert ctx.roofline() == pytest.approx(50.0)
    untraced = layers.Context(123.0, 4.0)
    assert untraced.roofline() is None


def test_spans_that_cannot_be_installed_are_named():
    """A program function that is gone, or whose module is, cannot carry
    its span: the run names it instead of losing it silently."""
    spans = (("fzbench.window", "Window.run", "ok.span"),
             ("fzbench.window", "Window.gone", "gone.span"),
             ("fzbench.no_such_module", "f", "nomod.span"))
    from fzbench import window

    real = window.Window.run
    with trace.program_spans(spans) as missing:
        assert window.Window.run is not real
    assert missing == ["gone.span", "nomod.span"]
    assert window.Window.run is real
    ev = [_ev("user_annotation", trace.CALL_SPAN, 0, 100),
          {"spans_missing": ["gone.span"]}]
    s = trace.summarize(ev)
    assert s["spans_missing"] == ["gone.span"]
