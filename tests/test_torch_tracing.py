"""The port's own spans and counters on the fitter path (`utils.tracing.span`,
`utils.metrics.metrics`), on the CPU.

A profiled `BruteForce.fit_predict` gives every span of its route, each
inside its parent, on the fused route with full masks (the screened
glue) and masked (the table route), and on a 3-shard mesh; the counters
equal the counts the call's shape gives; the results are the same bit
for bit traced or not; and with no profiler recording `span` hands out
one shared no-op context.
"""

import json

import numpy as np
import pytest
import torch

from frankenz_tpu_torch.models import BruteForce
from frankenz_tpu_torch.parallel import make_mesh
from frankenz_tpu_torch.utils import tracing as TT
from frankenz_tpu_torch.utils.metrics import metrics

# One torch thread per test worker (as tests/_torch_port.py sets it;
# that module imports JAX, and the card tests here run without JAX).
torch.set_num_threads(1)

M, F, NGRID = 600, 5, 33

# Every span's parent on the fitter path; the route-specific spans below.
PARENT = {
    "fitter.kernel_G": "fitter.fit_predict",
    "fitter.stream": "fitter.fit_predict",
    "fitter.stage": "fitter.stream",
    "stage.card": "fitter.stage",
    "fitter.batch": "fitter.stream",
    "fitter.launch": "fitter.batch",
    "fused.fit_pdf": "fitter.launch",
    "fitter.finish_shard": "fitter.batch",
    "readback.normalize": "fitter.finish_shard",
    "readback.copy": "fitter.finish_shard",
    # A batch's shards are stored while the next batch runs, the last
    # batch's after the loop: inside the stream, not inside a batch.
    "fitter.drain_shard": "fitter.stream",
    "readback.wait": "fitter.drain_shard",
    "readback.store": "fitter.drain_shard",
}
SCREENED = {
    "screen.screened": "fused.fit_pdf",
    "screen.seed": "screen.screened",
    "screen.gates": "screen.screened",
}
TABLE = {
    "fused.band_sort": "fitter.launch",
    "fused.table_route": "fused.fit_pdf",
    "fused.table_budget": "fused.table_route",
    "fused.table_chunk": "fused.table_route",
}


def _problem(n, masked, seed=0):
    rng = np.random.default_rng(seed)
    models = rng.uniform(1, 10, (M, F)).astype(np.float32)
    labels = rng.uniform(0, 3, M)
    data = (models[rng.integers(0, M, n)]
            + rng.normal(0, 0.2, (n, F))).astype(np.float32)
    mask = np.ones_like(data)
    if masked:
        mask[::3, 1] = 0.0
    return models, labels, (data, np.full_like(data, 0.2), mask)


def _fit(models, labels, cat, device="cpu", **kw):
    bf = BruteForce(models, 0.05 * models, np.ones_like(models),
                    device=device)
    pdf, (lmap, levid) = bf.fit_predict(
        *cat, labels, np.full(M, 0.05), label_grid=np.linspace(0, 3.2, NGRID),
        verbose=False, return_gof=True, **kw)
    return pdf, lmap, levid


def _traced(fn, logdir, threads=False):
    """fn()'s result and the user spans of its Chrome trace, as
    {name: [(start, end), ...]} in microseconds; with `threads`, each
    span also carries its thread, (start, end, tid)."""
    with TT.trace(str(logdir)):
        out = fn()
    (path,) = logdir.glob("*.json")
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"])
                + ((e.get("tid"),) if threads else ()))
    return out, spans


def _counted(fn):
    """fn()'s result and the registry's counters it added."""
    before = dict(metrics.counters)
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in metrics.counters.items()
                 if v != before.get(k, 0)}


def _assert_nested(spans, parents):
    # Chrome-trace times are microseconds rounded to the nanosecond.
    eps = 1e-2
    for child, parent in parents.items():
        assert child in spans, f"no span {child}"
        for s, e in spans[child]:
            assert any(ps - eps <= s and e <= pe + eps
                       for ps, pe in spans[parent]), (child, parent)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_fused_fit_predict_spans_and_counters(tmp_path, masked):
    n, batch = 300, 128
    models, labels, cat = _problem(n, masked)
    want = _fit(models, labels, cat, batch_size=batch)
    (got, spans), counts = _counted(lambda: _traced(
        lambda: _fit(models, labels, cat, batch_size=batch), tmp_path))
    route = TABLE if masked else SCREENED
    _assert_nested(spans, {**PARENT, **route})
    off_route = SCREENED if masked else TABLE
    assert not set(off_route) & set(spans)
    assert "fitter.cdf_rerun" not in spans
    nbatch = -(-n // batch)
    assert len(spans["fitter.fit_predict"]) == 1
    for name in ("fitter.batch", "fitter.launch", "fitter.finish_shard",
                 "readback.copy", "fitter.drain_shard", "readback.wait",
                 "readback.store", "fused.fit_pdf"):
        assert len(spans[name]) == nbatch, name
    assert counts == {
        "fitter.calls": 1, "pdf_stacks": n, "fitter.batches": nbatch,
        "fitter.shards": nbatch, "readback.bytes": n * (NGRID + 2) * 4,
        **({"fused.band_sorts": 1, "fused.table_chunks": nbatch}
           if masked else {})}
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mesh_fit_predict_spans_and_counters(tmp_path):
    """3 shards of the CPU: 301 rows pad to 303, batches of 128 round up
    to 129 (129, 129, 45 rows), 3 shards a batch; the pad rows never
    reach the host arrays or the bytes read back."""
    n, batch, ndev = 301, 128, 3
    models, labels, cat = _problem(n, masked=False)
    mesh = make_mesh(devices=["cpu"] * ndev)
    want = _fit(models, labels, cat, batch_size=batch)
    (got, spans), counts = _counted(lambda: _traced(
        lambda: _fit(models, labels, cat, batch_size=batch, mesh=mesh),
        tmp_path))
    _assert_nested(spans, {**PARENT, **SCREENED})
    assert len(spans["fitter.stage"]) == len(spans["stage.card"]) == 1
    assert len(spans["fitter.batch"]) == 3
    assert len(spans["fitter.launch"]) == len(spans["fused.fit_pdf"]) == 9
    assert len(spans["fitter.finish_shard"]) == 9
    assert len(spans["fitter.drain_shard"]) == 9
    assert counts == {"fitter.calls": 1, "pdf_stacks": n,
                      "fitter.batches": 3, "fitter.shards": 9,
                      "fitter.pad_rows": 2, "stage.cards": 1,
                      "readback.bytes": n * (NGRID + 2) * 4}
    # Traced on the mesh, the untraced single-device result bit for bit.
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
def test_card_fit_predict_stores_on_worker_threads(tmp_path):
    """On the card, masked in four batches: the launching thread's spans
    nest as on the CPU but for the store, which runs on the store
    workers (``readback.wait`` and ``readback.store``, one each a record
    of this size, none on the launching thread); the launching thread
    waits on the pool in ``readback.join``, inside the stream: before
    it reuses a slot (batches 3 and 4, inside ``readback.copy``) and
    once at its end.  ``readback.pooled`` counts every shard; the
    results are the untraced call's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, batch = 1024, 256
    models, labels, cat = _problem(n, masked=True)
    want = _fit(models, labels, cat, device="cuda", batch_size=batch)
    (got, spans), counts = _counted(lambda: _traced(
        lambda: _fit(models, labels, cat, device="cuda", batch_size=batch),
        tmp_path, threads=True))
    (main,) = {tid for *_, tid in spans["fitter.fit_predict"]}
    store = {"readback.wait", "readback.store"}
    on_main = {k: [(s, e) for s, e, tid in v if tid == main]
               for k, v in spans.items()}
    workers = {k: [tid for *_, tid in v if tid != main]
               for k, v in spans.items() if k in store}
    _assert_nested(on_main, {**{k: v for k, v in PARENT.items()
                                if k not in store},
                             "readback.join": "fitter.stream", **TABLE})
    assert not on_main["readback.wait"] and not on_main["readback.store"]
    assert len(workers["readback.wait"]) == len(workers["readback.store"])
    assert len(workers["readback.store"]) == 4
    assert len(on_main["readback.join"]) == 3
    copies = on_main["readback.copy"]
    assert sum(any(cs <= s and e <= ce for cs, ce in copies)
               for s, e in on_main["readback.join"]) == 2
    assert counts["readback.pooled"] == counts["fitter.shards"] == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("ndev", [1, 2])
def test_stage_counts_cards_and_no_copy_on_the_cpu(ndev):
    """The stage on the CPU copies nothing onto a card: ``stage.bytes``
    stays 0; a mesh counts the distinct devices it staged (2 shards of
    the CPU: 1 a call) and one device counts as it did before."""
    n, batch = 64, 32
    models, labels, cat = _problem(n, masked=True)
    kw = dict(mesh=make_mesh(devices=["cpu"] * ndev)) if ndev > 1 else {}
    _, counts = _counted(lambda: [_fit(models, labels, cat,
                                       batch_size=batch, **kw)
                                  for _ in range(2)])
    assert "stage.bytes" in metrics.counters
    assert "stage.bytes" not in counts
    assert counts == {
        "fitter.calls": 2, "pdf_stacks": 2 * n, "fitter.batches": 4,
        "fitter.shards": 4 * ndev, "readback.bytes": 2 * n * (NGRID + 2) * 4,
        "fused.band_sorts": 2, "fused.table_chunks": 4 * ndev,
        **({"stage.cards": 2} if ndev > 1 else {})}


def test_span_is_a_shared_no_op_unless_a_profiler_records():
    off = TT.span("fitter.batch")
    assert off is TT.span("readback.copy") is TT.annotate("x")
    with off:
        pass
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        on = TT.span("fitter.batch")
        assert on is not off
        assert isinstance(on, torch.profiler.record_function)
    assert TT.span("fitter.batch") is off
