"""Port parity for the slice: BruteForce.fit_predict and fit_summarize.

The JAX fitter is built from NumPy inputs, carried across with
`from_jax_bruteforce`, and both fit the same catalog (B=300, M=2000,
F=5, Ngrid=101).  The port's default route on the CPU is the screened
full-mask kernels' plain versions; it is held against JAX's
`use_fused=True` (the screened Pallas route, interpret mode) and `use_fused=False` (XLA),
at tests/test_fused.py's tolerances: lmap / levid 2e-5, PDFs rtol 2e-3
atol 2e-5.  Summaries follow tests/test_fit_summarize.py: rtol 2e-3 /
atol 2e-4 across routes (PDF differences move quantiles), and exact-
route comparisons at 2e-5 / 2e-6.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from _torch_port import to_numpy
from frankenz_tpu.models import BruteForce as JaxBruteForce
from frankenz_tpu.ops import summarize as JS
from frankenz_tpu_torch.models import bruteforce as TBF
from frankenz_tpu_torch.ops import pdfs_summarize
from frankenz_tpu_torch.ops import summarize as TS
from frankenz_tpu_torch.utils import from_jax_bruteforce
from frankenz_tpu_torch.utils.metrics import metrics

GOF_TOL = dict(rtol=2e-5, atol=2e-5)
PDF_TOL = dict(rtol=2e-3, atol=2e-5)


@pytest.fixture(scope="module")
def slice_problem():
    rng = np.random.default_rng(2)
    B, M, F, Ngrid = 300, 2000, 5, 101
    f32 = np.float32
    models = rng.uniform(1, 10, (M, F)).astype(f32)
    models_err = (0.05 * models).astype(f32)
    data = (models[rng.integers(0, M, B)]
            + rng.normal(0, 0.25, (B, F))).astype(f32)
    p = dict(models=models, models_err=models_err,
             models_mask=np.ones((M, F), f32), data=data,
             data_err=np.full((B, F), 0.25, f32),
             data_mask=np.ones((B, F), f32),
             zlab=rng.uniform(0, 3, M), zerr=np.full(M, 0.1),
             grid=np.linspace(0, 3, Ngrid))
    jbf = JaxBruteForce(p["models"], p["models_err"], p["models_mask"])
    p["jax"] = jbf
    p["torch"] = from_jax_bruteforce(jbf, device="cpu")
    p["args"] = (p["data"], p["data_err"], p["data_mask"], p["zlab"],
                 p["zerr"])
    p["kw"] = dict(label_grid=p["grid"], verbose=False, return_gof=True)
    return p


@pytest.fixture(scope="module")
def port_fit(slice_problem):
    p = slice_problem
    return p["torch"].fit_predict(*p["args"], **p["kw"])


def _assert_fit_close(got, want):
    pdf_g, (lmap_g, levid_g) = got
    pdf_w, (lmap_w, levid_w) = want
    assert pdf_g.shape == pdf_w.shape
    np.testing.assert_allclose(lmap_g, lmap_w, **GOF_TOL)
    np.testing.assert_allclose(levid_g, levid_w, **GOF_TOL)
    np.testing.assert_allclose(pdf_g, pdf_w, **PDF_TOL)


@pytest.mark.parametrize("jax_fused", [True, False])
def test_fit_predict_matches_jax(slice_problem, port_fit, jax_fused):
    p = slice_problem
    want = p["jax"].fit_predict(*p["args"], use_fused=jax_fused, **p["kw"])
    _assert_fit_close(port_fit, want)
    rows = port_fit[0].sum(1)
    np.testing.assert_allclose(rows, 1.0, rtol=1e-5)
    # levid = lmap + log(sum of weights), the largest weight being ~1: a
    # row with one dominant model can sit 1 ulp below lmap (JAX too).
    lmap, levid = port_fit[1]
    assert np.all(lmap <= levid + 1e-6 * (1.0 + np.abs(lmap)))


def test_plain_path_matches_jax_plain_path(slice_problem):
    """use_fused=False: the plain composition on both sides."""
    p = slice_problem
    got = p["torch"].fit_predict(*p["args"], use_fused=False,
                                 batch_size=128, **p["kw"])
    want = p["jax"].fit_predict(*p["args"], use_fused=False, **p["kw"])
    np.testing.assert_allclose(got[1][0], want[1][0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1][1], want[1][1], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-6)


def test_fit_summarize_matches_jax_and_own_pdfs(slice_problem, port_fit):
    p = slice_problem
    kw = dict(label_grid=p["grid"], verbose=False)
    got, gof = p["torch"].fit_summarize(*p["args"], **kw)
    want, _ = p["jax"].fit_summarize(*p["args"], use_fused=True, **kw)
    cols = np.asarray(JS._pack_summary(got))
    assert cols.shape == (300, TS.SUMMARY_NCOLS)
    np.testing.assert_allclose(cols, np.asarray(JS._pack_summary(want)),
                               rtol=2e-3, atol=2e-4)
    # == pdfs_summarize(fit_predict(...)) under the same uniforms
    u = np.random.default_rng(0).random(len(port_fit[0]))
    own = pdfs_summarize(torch.from_numpy(port_fit[0]), p["grid"], u=u)
    np.testing.assert_allclose(cols, to_numpy(TS._pack_summary(own)),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(gof[0], port_fit[1][0])


def test_fit_then_predict_matches_jax(slice_problem):
    p = slice_problem
    sub = tuple(a[:40] for a in p["args"][:3])
    tbf, jbf = p["torch"], p["jax"]
    tbf.fit(*sub, verbose=False)
    jbf.fit(*sub, verbose=False)
    np.testing.assert_allclose(tbf.fit_lnprob, jbf.fit_lnprob, rtol=1e-5,
                               atol=1e-5)
    kw = dict(label_grid=p["grid"], verbose=False, return_gof=True)
    got = tbf.predict(p["zlab"], p["zerr"], **kw)
    want = jbf.predict(p["zlab"], p["zerr"], **kw)
    _assert_fit_close(got, want)


def test_unported_options_raise(slice_problem):
    """The mesh= refusals of the JAX fitter (bruteforce.py:589-602) and a
    mesh that is not a `parallel.Mesh`."""
    from frankenz_tpu_torch.parallel import make_mesh

    p = slice_problem
    bf = p["torch"]
    with pytest.raises(TypeError, match="Mesh"):
        bf.fit_predict(*p["args"], mesh=object(), **p["kw"])
    mesh = make_mesh(devices=["cpu"] * 2)
    for bad in (dict(save_fits=True), dict(track_scale=True)):
        with pytest.raises(ValueError, match="mesh"):
            bf.fit_predict(*p["args"], mesh=mesh, **bad, **p["kw"])
    with pytest.raises(ValueError, match="cdf_thresh selection"):
        bf.fit_predict(*p["args"], mesh=mesh, use_fused=True,
                       wt_thresh=None, **p["kw"])
    # Checkpoints are ported: resuming without a file fails fast.
    with pytest.raises(ValueError, match="checkpoint_file"):
        bf.fit(*p["args"][:3], resume=True, verbose=False)
    with pytest.raises(ValueError):
        bf.fit_predict(*p["args"], use_fused=True, save_fits=True,
                       **p["kw"])


def test_cuda_device_without_a_card_raises(slice_problem):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from frankenz_tpu_torch.models import BruteForce

    p = slice_problem
    with pytest.raises(RuntimeError, match="CUDA"):
        BruteForce(p["models"], p["models_err"], p["models_mask"])


# ---------------------------------------------------------------------
# The overlapped readback: each batch's shards are stored into the host
# arrays while the next batch runs (`BruteForce._stream`).
# ---------------------------------------------------------------------

RB_M, RB_F, RB_NGRID = 600, 5, 33


def _rb_problem(n, masked=False, seed=0):
    rng = np.random.default_rng(seed)
    models = rng.uniform(1, 10, (RB_M, RB_F)).astype(np.float32)
    data = (models[rng.integers(0, RB_M, n)]
            + rng.normal(0, 0.2, (n, RB_F))).astype(np.float32)
    mask = np.ones_like(data)
    if masked:
        mask[::3, 1] = 0.0
    bf = TBF.BruteForce(models, 0.05 * models, np.ones_like(models),
                        device="cpu")
    args = (data, np.full_like(data, 0.2), mask, rng.uniform(0, 3, RB_M),
            np.full(RB_M, 0.05))
    return bf, args


def _rb_call(bf, args, route, **kw):
    """One call of `route`: its host arrays, flattened."""
    kw = dict(label_grid=np.linspace(0, 3.2, RB_NGRID), verbose=False,
              **kw)
    if route == "summarize":
        summary, gof = bf.fit_summarize(*args, **kw)
        return [np.asarray(a) for a in _leaves(summary)] + list(gof)
    extra = dict(free=dict(lprob_kwargs={"free_scale": True}),
                 plain=dict(use_fused=False)).get(route, {})
    pdf, gof = bf.fit_predict(*args, return_gof=True, **kw, **extra)
    return [pdf, *gof]


def _leaves(x):
    if isinstance(x, tuple):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _store_at_once(monkeypatch):
    """Store every shard as soon as its copy starts, before the next
    batch is launched: the fitter's per-batch order without the
    lookahead (no record is left pending for `_stream`)."""
    finish = TBF.BruteForce._finish_shard

    def at_once(host, j0, out, post):
        finish(host, j0, out, post)
        TBF.BruteForce._drain_pending(host)

    monkeypatch.setattr(TBF.BruteForce, "_finish_shard",
                        staticmethod(at_once))


def _counted(fn):
    before = dict(metrics.counters)
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in metrics.counters.items()
                 if v != before.get(k, 0)}


@pytest.mark.parametrize("route,n,masked,ndev", [
    ("full", 300, False, 1), ("masked", 300, True, 1), ("free", 300, True, 1),
    ("plain", 300, True, 1), ("summarize", 300, True, 1),
    ("mesh", 301, False, 3)])
def test_overlapped_readback_matches_per_batch_order(monkeypatch, route, n,
                                                     masked, ndev):
    """Batches of 128 rows (129 on 3 shards, the last ragged; the mesh
    pads 301 rows to 303): the lookahead's host arrays equal, bit for
    bit, those of the same call storing each shard before the next
    batch is launched."""
    from frankenz_tpu_torch.parallel import make_mesh

    bf, args = _rb_problem(n, masked)
    kw = dict(batch_size=128)
    if ndev > 1:
        kw["mesh"] = make_mesh(devices=["cpu"] * ndev)
    got, counts = _counted(lambda: _rb_call(bf, args, route, **kw))
    with monkeypatch.context() as mp:
        _store_at_once(mp)
        want, at_once = _counted(lambda: _rb_call(bf, args, route, **kw))
    assert counts["readback.bytes"] == at_once["readback.bytes"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_overlapped_readback_cdf_reruns_land_last(monkeypatch):
    """The cdf mode with the first and last of three batches flagged:
    their streamed results (PDFs flipped, lmap and levid + 1) are
    stored, then their reruns overwrite them, the last batch's too,
    whose streamed store lands after the stream's loop.  The unflagged
    batch keeps its streamed rows."""
    bf, args = _rb_problem(300, masked=True)
    kw = dict(batch_size=128, wt_thresh=None, cdf_thresh=2e-4)
    true = _rb_call(bf, args, "masked", **kw)
    orig = TBF._fused.fused_fit_pdf
    deferred = []

    def streamed_off(flag):
        def fit(*a, **k):
            if not k["defer_cdf_check"]:
                return orig(*a, **k)
            pdf, lmap, levid, ok = orig(*a, **k)
            deferred.append(bool(ok))
            bad = flag and len(deferred) in (1, 3)
            return (torch.flip(pdf, [1]), lmap + 1, levid + 1,
                    torch.tensor(not bad))
        return fit

    monkeypatch.setattr(TBF._fused, "fused_fit_pdf", streamed_off(False))
    streamed = _rb_call(bf, args, "masked", **kw)
    assert bf.cdf_reruns == 0
    deferred.clear()
    monkeypatch.setattr(TBF._fused, "fused_fit_pdf", streamed_off(True))
    got = _rb_call(bf, args, "masked", **kw)
    assert bf.cdf_reruns == 2
    rerun = np.r_[0:128, 256:300]
    for g, t, s in zip(got, true, streamed):
        np.testing.assert_array_equal(g[rerun], t[rerun])
        np.testing.assert_array_equal(g[128:256], s[128:256])
        assert not np.array_equal(t[128:256], s[128:256])


@pytest.mark.parametrize("route", ["full", "masked"])
def test_overlapped_readback_outputs_own_their_memory(route):
    """Two calls back to back on different chunks: the second leaves the
    first's arrays as they were, and no array of one call shares memory
    with the other's."""
    bf, args = _rb_problem(300, masked=route == "masked")
    chunks = [tuple(a[i:i + 150] for a in args[:3]) + args[3:]
              for i in (0, 150)]
    first = _rb_call(bf, chunks[0], route, batch_size=64)
    kept = [a.copy() for a in first]
    second = _rb_call(bf, chunks[1], route, batch_size=64)
    for a, k, b in zip(first, kept, second):
        np.testing.assert_array_equal(a, k)
        assert not np.shares_memory(a, b)
        assert not np.array_equal(a, b)


@pytest.mark.parametrize("n,batch,ndev,nbatch", [
    (300, 128, 1, 3), (300, 512, 1, 1), (301, 128, 3, 3), (64, 16, 3, 4)])
def test_overlapped_readback_counts(monkeypatch, n, batch, ndev, nbatch):
    """Each batch's shards start their copies, then the previous batch's
    are stored, and the last batch's after the loop: (batches - 1) x
    shards stores a call run while a later batch is enqueued (0 for one
    batch); ``readback.bytes`` counts the rows that are not padding, as
    before the lookahead."""
    from frankenz_tpu_torch.parallel import make_mesh

    bf, args = _rb_problem(n)
    kw = dict(batch_size=batch)
    if ndev > 1:
        kw["mesh"] = make_mesh(devices=["cpu"] * ndev)
    rows = -(-batch // ndev) * ndev
    finish, drain, log = (TBF.BruteForce._finish_shard,
                          TBF.BruteForce._drain_shard, [])

    def logged_finish(host, j0, out, post):
        log.append(("finish", j0 // rows))
        finish(host, j0, out, post)

    def logged_drain(host, rec):
        log.append(("drain", rec.j0 // rows))
        drain(host, rec)

    monkeypatch.setattr(TBF.BruteForce, "_finish_shard",
                        staticmethod(logged_finish))
    monkeypatch.setattr(TBF.BruteForce, "_drain_shard",
                        staticmethod(logged_drain))
    _, counts = _counted(lambda: _rb_call(bf, args, "full", **kw))
    assert counts["fitter.batches"] == nbatch
    # Every shard holds rows that are not padding here.
    assert log == [(op, b) for k in range(nbatch + 1)
                   for op, b in [("finish", k)] * ndev * (k < nbatch)
                   + [("drain", k - 1)] * ndev * (k > 0)]
    later = [b for k, (op, b) in enumerate(log) if op == "drain"
             and ("finish", b + 1) in log[:k]]
    assert len(later) == (nbatch - 1) * ndev
    assert counts["readback.bytes"] == n * (RB_NGRID + 2) * 4


# ---------------------------------------------------------------------
# The store pool: on the card a record with pinned staging goes to the
# store workers (`_drain_shard`).  Hand-built records carry an event
# stand-in, so the pool engages on the CPU.
# ---------------------------------------------------------------------

class _Gate:
    """An event stand-in: `synchronize` waits until `open` (bounded),
    or raises `error`."""

    def __init__(self, opened=True, error=None):
        self.gate, self.error = threading.Event(), error
        if opened:
            self.gate.set()

    def open(self):
        self.gate.set()

    def synchronize(self):
        assert self.gate.wait(30), "gate never opened"
        if self.error is not None:
            raise self.error


def _pool_host(ndata, width):
    return TBF._HostArrays((np.zeros((ndata, width), np.float32),
                            np.zeros(ndata, np.float32),
                            np.zeros(ndata, np.float32)))


def _pool_record(rows, width, j0, m, event, seed=0):
    rng = np.random.default_rng(seed)
    slot = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((rows, width), (rows,), (rows,))]
    return TBF._Readback(slot, event, j0, m)


@pytest.mark.parametrize("rows,width,j0,m", [
    (30_001, RB_NGRID * 9 + 4, 0, 30_001),
    (30_001, RB_NGRID * 9 + 4, 7, 29_990),
    (1, RB_NGRID, 5, 1),
    (20_000, TS.SUMMARY_NCOLS, 3, 19_999),
    (2_048, 301, 0, 2_048)])
def test_pooled_store_matches_one_thread_store(rows, width, j0, m):
    """A record with an event goes to the store workers and equals, bit
    for bit, the one-thread store of the same record (its event None):
    split into ranges where it holds 4 MB a worker or more (30,001 rows
    divide by no pool size but 1), one task where it holds less (1 row,
    a 2,048-row call), and at `fit_summarize`'s width.  The first `m`
    rows land at `j0`; the rest of the arrays stay 0."""
    ndata = j0 + m + 2
    pooled, plain = _pool_host(ndata, width), _pool_host(ndata, width)
    rec = _pool_record(rows, width, j0, m, _Gate())
    _, workers = TBF._store_pool()
    ranges = TBF._row_ranges(m, width * 4 + 8, workers)
    assert ranges[0][0] == 0 and ranges[-1][1] == m
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    big = m * (width * 4 + 8) >= 2 * TBF._STORE_LEAST_BYTES
    assert len(ranges) == (min(workers, m * (width * 4 + 8)
                               // TBF._STORE_LEAST_BYTES) if big else 1)
    _, counts = _counted(lambda: TBF.BruteForce._drain_shard(pooled, rec))
    TBF.BruteForce._drain_pending(pooled)
    TBF.BruteForce._drain_shard(plain, rec._replace(event=None))
    assert counts == {"readback.pooled": 1}
    assert [s for s, _ in pooled.free] == [rec.slot] and not plain.free
    for got, want, src in zip(pooled, plain, rec.slot):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[j0:j0 + m], src[:m].numpy())
        assert not got[:j0].any() and not got[j0 + m:].any()


def test_pooled_slot_is_not_reused_before_its_stores():
    """`_drain_shard` returns before a gated record is stored; taking its
    slot for the next copies (`_HostArrays.take`, as `_finish_shard`
    does) and the end of the stream (`_drain_pending`) both wait until
    the stores have run, and then find the rows in the host arrays."""
    host = _pool_host(40_000, 301)
    first, second = _Gate(opened=False), _Gate(opened=False)
    rec = _pool_record(20_000, 301, 0, 20_000, first, seed=1)
    TBF.BruteForce._drain_shard(host, rec)
    assert not host[0].any() and not host[1].any()
    taken = []
    taker = threading.Thread(target=lambda: taken.append(host.take(20_000)))
    taker.start()
    taker.join(0.3)
    assert taker.is_alive() and not taken
    assert host.take(20_001) is None
    first.open()
    taker.join(30)
    assert not taker.is_alive()
    assert taken == [rec.slot] and not host.free
    np.testing.assert_array_equal(host[0][:20_000], rec.slot[0].numpy())
    later = _pool_record(20_000, 301, 20_000, 20_000, second, seed=2)
    host.pending.append(later)
    drainer = threading.Thread(
        target=lambda: TBF.BruteForce._drain_pending(host))
    drainer.start()
    drainer.join(0.3)
    assert drainer.is_alive()
    second.open()
    drainer.join(30)
    assert not drainer.is_alive() and not host.pending
    np.testing.assert_array_equal(host[0][20_000:], later.slot[0].numpy())
    np.testing.assert_array_equal(host[2][20_000:], later.slot[2].numpy())


@pytest.mark.parametrize("at", ["take", "drain_pending"])
def test_pooled_store_error_is_raised_at_the_join(at):
    """A worker's exception does not escape `_drain_shard`; it is raised
    on the launching thread where that waits on the pool: taking the
    slot again, or the end of the stream."""
    host = _pool_host(100, RB_NGRID)
    bad = _Gate(error=RuntimeError("copy failed"))
    TBF.BruteForce._drain_shard(
        host, _pool_record(100, RB_NGRID, 0, 100, bad))
    with pytest.raises(RuntimeError, match="copy failed"):
        if at == "take":
            host.take(100)
        else:
            TBF.BruteForce._drain_pending(host)


def test_pooled_counter_counts_pooled_records_only():
    """``readback.pooled`` counts each record stored by the pool, one per
    record whatever its split, and a call on the CPU, whose records hold
    the outputs themselves, counts none."""
    host = _pool_host(40_000, 301)
    recs = [_pool_record(20_000, 301, 0, 20_000, _Gate()),
            _pool_record(10, 301, 20_000, 10, _Gate()),
            _pool_record(10, 301, 20_010, 10, None)]

    def drain():
        for rec in recs:
            TBF.BruteForce._drain_shard(host, rec)
        TBF.BruteForce._drain_pending(host)

    _, counts = _counted(drain)
    assert counts == {"readback.pooled": 2}
    assert len(host.free) == 2
    bf, args = _rb_problem(300)
    _, counts = _counted(lambda: _rb_call(bf, args, "full", batch_size=128))
    assert counts["fitter.shards"] == 3 and "readback.pooled" not in counts


def test_pooled_stores_under_contention(monkeypatch):
    """Stress: 48 records of 5 to 400 rows, split into 1-row-minimum
    ranges, on a pool of 32 workers (more than the cores) with a thread
    switch every microsecond: every row of the host arrays holds its own
    record's values."""
    pool = TBF.futures.ThreadPoolExecutor(32)
    monkeypatch.setattr(TBF, "_store_pool", lambda: (pool, 32))
    monkeypatch.setattr(TBF, "_STORE_LEAST_BYTES", 1)
    rng = np.random.default_rng(3)
    sizes = rng.integers(5, 400, 48)
    starts = np.r_[0, np.cumsum(sizes)[:-1]]
    host = _pool_host(int(sizes.sum()), RB_NGRID)
    recs = [_pool_record(int(n) + 3, RB_NGRID, int(j0), int(n), _Gate(),
                         seed=k) for k, (n, j0) in enumerate(zip(sizes,
                                                                 starts))]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for rec in recs:
            TBF.BruteForce._drain_shard(host, rec)
        TBF.BruteForce._drain_pending(host)
    finally:
        sys.setswitchinterval(switch)
        pool.shutdown(wait=True)
    for rec in recs:
        for h, t in zip(host, rec.slot):
            np.testing.assert_array_equal(h[rec.j0:rec.j0 + rec.m],
                                          t[:rec.m].numpy())
