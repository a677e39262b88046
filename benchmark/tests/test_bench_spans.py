"""The program's spans in a trace (`fzbench.spans`), the readback's GB/s
reader, and `span_split.py` on a tiny cell (the port's plain kernels on
the CPU)."""

import pytest

import bench_util
import span_split
from fzbench import layers, spans, spec, trace


def _ev(cat, name, ts, dur, dev=0, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": dev, "args": {"device": dev}}


def _calls():
    return [_ev("user_annotation", trace.CALL_SPAN, 0, 100),
            _ev("user_annotation", trace.CALL_SPAN, 100, 100)]


def test_nested_spans_of_one_name_count_once():
    # The benchmark's wrapper [10, 60] holds the program's span [12, 58]
    # of the same name; a second, separate range [120, 130]; a range on
    # another thread and one past the window do not count.
    ev = _calls() + [
        _ev("user_annotation", "fitter.finish_shard", 10, 50),
        _ev("user_annotation", "fitter.finish_shard", 12, 46),
        _ev("user_annotation", "fitter.finish_shard", 120, 10),
        _ev("user_annotation", "fitter.finish_shard", 70, 10, tid=2),
        _ev("user_annotation", "readback.copy", 190, 30),
        _ev("cpu_op", "aten::copy_", 20, 5)]
    got = spans.span_seconds(ev)
    assert got["fitter.finish_shard"] == (pytest.approx(60e-6), 2)
    assert got["readback.copy"] == (pytest.approx(10e-6), 1)
    # Two calls back to back: two ranges, not one.
    assert got[trace.CALL_SPAN] == (pytest.approx(200e-6), 2)
    assert "aten::copy_" not in got
    assert spans.span_seconds([]) == {}


def test_idle_goes_to_the_innermost_program_span():
    # Device busy [0, 10] and [90, 110]; idle [10, 90] and [110, 200].
    # The first idle stretch's midpoint (50) lies in readback.copy inside
    # fitter.finish_shard, under an aten::copy_ that does not count; the
    # second's (155) in bench.call alone.
    ev = _calls() + [
        _ev("kernel", "k", 0, 10), _ev("gpu_memcpy", "Memcpy DtoH", 90, 20),
        _ev("user_annotation", "fitter.finish_shard", 5, 95),
        _ev("user_annotation", "fitter.finish_shard", 6, 93),
        _ev("user_annotation", "readback.copy", 20, 60),
        _ev("cpu_op", "aten::copy_", 21, 58),
        _ev("cuda_runtime", "cudaMemcpyAsync", 22, 56)]
    idle = spans.idle_by_span(ev)
    assert idle == {trace.CALL_SPAN: pytest.approx(90e-6),
                    "readback.copy": pytest.approx(80e-6)}
    s = trace.summarize(ev)
    total = s["window_s"] - s["devices"][0]["busy_s"]
    assert sum(idle.values()) == pytest.approx(total)
    # The summary's breakdown charges the first stretch to the runtime
    # call instead: the two reductions split the same idle time.
    assert dict(s["idle_gaps"])["cudaMemcpyAsync"] == pytest.approx(80e-6)
    assert sum(v for _, v in s["idle_gaps"]) == pytest.approx(total)


def test_idle_by_span_sums_to_the_idle_time_of_the_window_test():
    """On `test_bench_window`'s trace: every idle stretch under
    ``bench.call`` (no other span), their sum the summary's idle time."""
    ev = _calls() + [
        _ev("cpu_op", "aten::copy_", 150, 40),
        _ev("kernel", "k1", 10, 30), _ev("kernel", "k2", 20, 30),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 150, 40),
        _ev("gpu_memset", "Memset", 60, 10)]
    idle = spans.idle_by_span(ev)
    assert idle == {trace.CALL_SPAN: pytest.approx(110e-6)}
    s = trace.summarize(ev)
    assert dict(s["idle_gaps"]) == {trace.CALL_SPAN: pytest.approx(110e-6)}


def test_counter_change_leaves_out_what_came_before():
    before = {"fitter.calls": 1, "readback.bytes": 700, "cdf_reruns": 2}
    after = {"fitter.calls": 4, "readback.bytes": 2800, "cdf_reruns": 2,
             "fused.table_chunks": 6}
    assert spans.counter_change(before, after) == {
        "fitter.calls": 3, "readback.bytes": 2100, "fused.table_chunks": 6}


def test_readback_gbps_reads_the_program_counters(monkeypatch):
    from frankenz_tpu_torch.utils.metrics import metrics

    read = spec.reader("readback_gbps.masked")
    s = trace.summarize(_calls() + [
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 10, 40),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 110, 60)])
    traced = layers.Context(1.0, 1.0, trace=s)
    monkeypatch.setattr(metrics, "counters", {})
    assert read(traced) is None
    assert read(layers.Context(1.0, 1.0)) is None
    # Four calls of 5e5 bytes each (the warm call among them) over 50 us
    # of DtoH a traced call: 10 GB/s.
    monkeypatch.setattr(metrics, "counters",
                        {"fitter.calls": 4, "readback.bytes": 2_000_000})
    assert read(traced) == pytest.approx(10.0)
    assert read(layers.Context(1.0, 1.0)) is None


def test_span_split_on_a_tiny_cell():
    c = bench_util.tiny_cell("hsc-bf.masked", objects=512, batch=256)
    got = span_split.split(c, 2 ** 31 + 777, 0.3, device="cpu")
    assert got["failed"] == 0 and got["calls"] >= 1
    n = got["calls"]
    grid = int(c.config["grid"]["n"])
    assert got["counters"] == {
        "fitter.calls": n, "pdf_stacks": 512 * n, "fitter.batches": 2 * n,
        "fitter.shards": 2 * n,
        "readback.bytes": 512 * (grid + 2) * 4 * n,
        "fused.band_sorts": n, "fused.table_chunks": 2 * n}
    for name in ("fitter.fit_predict", "fitter.stream", "fitter.batch",
                 "readback.copy", "readback.store", "fused.table_chunk"):
        assert got["spans"][name][1] == (1 if name in (
            "fitter.fit_predict", "fitter.stream") else 2) * n, name
    # No device on the CPU: nothing idle to attribute.
    assert got["idle_by_span"] == {}
