"""Port parity: the band order of the port's stacks (`lnl_onepass`,
`lnl_cut_stack`, the table route's `lnl_stack_band`, the K1 pair's
`chi2_stack`; K7, JAX's band skip) against the JAX package on the CPU.

`kernels.general.band_sort` is held against JAX's `_band_sort`
(frankenz_tpu/ops/fused.py:243-267) on the same G: the same permutation,
and per 64-model tile the exact nonzero band of the sorted rows, which
covers every 128-column block JAX flags.  The port's one-pass and cdf
routes (`fused_fit_pdf`, the plain versions on CPU tensors) are held
against JAX's `fused_fit_pdf(interpret=True, band_skip=True)` at
Ngrid = 301, where JAX band-sorts, at tests/test_fused.py's tolerances
(lmap / levid rtol 2e-5, atol 1e-5; PDFs rtol 1e-3, atol 1e-5); free
scale at Ngrid = 101, where JAX keeps the caller's convergence groups
(ROADMAP section 3, "The label grid").  A straddling tie group whose
members sort apart keeps its caller-order members; the free-scale stacks
read caller-order sweep groups under a non-identity band order; and the
table route's row chunks follow the free device memory (a monkeypatched
budget) without changing a bit.  The `wt_thresh` table route (band order,
`lnl_stack_band`) on masked and full masks, dim prior and Normal, model
errors kept or ignored, and free scale, and the K1 pair (``screen=False``)
are held against JAX's band-skip routes at the same tolerances; free
scale with model errors keeps the caller-order table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_numpy
from frankenz_tpu.ops import fused as JF
from frankenz_tpu.ops import kde as JK
from frankenz_tpu.ops import likelihood as JL
from frankenz_tpu_torch.kernels import general as GK
from frankenz_tpu_torch.ops import fused as TF

GOF_TOL = dict(rtol=2e-5, atol=1e-5)
PDF_TOL = dict(rtol=1e-3, atol=1e-5)
CDF_PDF_TOL = dict(rtol=1e-4, atol=1e-6)
IME_TOL = dict(gof=dict(rtol=1e-4, atol=1e-4), pdf=dict(rtol=5e-3, atol=5e-5))
ME_TOL = dict(gof=dict(rtol=1e-3, atol=1e-3), pdf=dict(rtol=3e-3, atol=1e-4))
ONEPASS = dict(wt_thresh=None, cdf_thresh=None)
CDF = dict(wt_thresh=None, cdf_thresh=2e-4)


def _problem(B=24, M=300, F=5, Ngrid=301, seed=17):
    """tests/test_fused.py's `problem` generator at `Ngrid` points."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(1, 10, (M, F)).astype(np.float32)
    me = (0.05 * m).astype(np.float32)
    mm = (rng.uniform(size=(M, F)) > 0.1).astype(np.float32)
    mm[:, :2] = 1.0
    truth = rng.integers(0, M, B)
    d = (m[truth] + rng.normal(0, 0.3, (B, F))).astype(np.float32)
    de = np.full((B, F), 0.3, np.float32)
    dm = (rng.uniform(size=(B, F)) > 0.1).astype(np.float32)
    dm[:, :2] = 1.0
    G = np.asarray(JK.kernel_matrix(
        rng.uniform(0, 3, M), np.full(M, 0.1), np.linspace(0, 3, Ngrid)),
        np.float32)
    return d, de, dm, m, me, mm, G


@pytest.fixture(scope="module")
def problem():
    return _problem()


def _full(prob):
    d, de, dm, m, me, mm, G = prob
    return d, de, np.ones_like(dm), m, me, np.ones_like(mm), G


def _jax(*args, **kw):
    return to_numpy(JF.fused_fit_pdf(*args, tb=8, tm=128, interpret=True,
                                     screen=False, band_skip=True, **kw))


def _port(*args, **kw):
    return to_numpy(TF.fused_fit_pdf(*args, **kw))


def _assert_close(got, want, gof=GOF_TOL, pdf=PDF_TOL):
    assert got[0].shape == want[0].shape and got[0].dtype == np.float32
    np.testing.assert_allclose(got[1], want[1], **gof)
    np.testing.assert_allclose(got[2], want[2], **gof)
    np.testing.assert_allclose(got[0], want[0], **pdf)


def _tensors(m, me, mm, G):
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in (G, m.T, me.T, mm.T)]


@pytest.mark.parametrize("M", [300, 1000])
def test_band_sort_matches_jax(problem, M):
    """The permutation of JAX's `_band_sort` (read off a model array of
    caller indices it permutes with G), its sorted G, and per 64-model
    tile the exact nonzero band of the sorted rows; every 128-column
    block JAX flags for a model tile lies inside the bands of its 64-model
    tiles.  M = 1000 leaves a ragged last tile (JAX pads with zero rows,
    which sort last)."""
    _, _, _, m, me, mm, _ = problem
    rng = np.random.default_rng(3)
    G = np.asarray(JK.kernel_matrix(
        rng.uniform(0, 3, M), np.full(M, 0.1), np.linspace(0, 3, 301)),
        np.float32)
    G[5] = 0.0  # an all-zero row sorts last
    m = rng.uniform(1, 10, (M, 5)).astype(np.float32)
    tm = 128
    mp, gp = -(-M // tm) * tm, 384
    Gj = jnp.pad(jnp.asarray(G), ((0, mp - M), (0, gp - 301)))
    idx = jnp.arange(mp, dtype=jnp.float32)[None]
    Gs, flags, (idx_s,) = JF._band_sort(Gj, mp // tm, tm, gp // 128, (idx,))
    perm_j = np.asarray(idx_s)[0].astype(np.int64)
    bs = GK.band_sort(*_tensors(m, 0.05 * m, np.ones_like(m), G))
    np.testing.assert_array_equal(bs.perm.numpy(), perm_j[:M])
    assert (perm_j[M:] >= M).all()
    np.testing.assert_array_equal(bs.inv.numpy()[bs.perm.numpy()],
                                  np.arange(M))
    np.testing.assert_array_equal(bs.G.numpy()[:M, :301],
                                  np.asarray(Gs)[:M, :301])
    assert not bs.G.numpy()[M:].any() and not bs.G.numpy()[:, 301:].any()
    np.testing.assert_array_equal(bs.mT.numpy(), m.T[:, perm_j[:M]])
    nz = bs.G.numpy() != 0
    for t, (lo, hi) in enumerate(bs.bands.numpy()):
        cols = np.nonzero(nz[64 * t:64 * t + 64].any(axis=0))[0]
        assert (lo, hi) == ((cols[0], cols[-1] + 1) if cols.size else (0, 0))
    spans = [max(0, ((hi + 3) // 4 - lo // 4) * 4)
             for lo, hi in bs.bands.numpy()]
    assert bs.width == max(spans)
    for j, row in enumerate(np.asarray(flags)):
        tiles = bs.bands.numpy()[j * tm // 64:(j + 1) * tm // 64]
        for blk in np.nonzero(row)[0]:
            assert any(lo < 128 * (blk + 1) and hi > 128 * blk
                       for lo, hi in tiles if hi > lo)


ROUTE_CASES = [(route, mask, dp, ime)
               for route in ("onepass", "cdf")
               for mask in ("masked", "full")
               for dp in (True, False)
               for ime in (False, True)
               # full masks + dim prior + fixed scale, one pass: the
               # screened route, not a band stack
               if not (route == "onepass" and mask == "full" and dp)]


@pytest.mark.parametrize("route,mask,dim_prior,ignore_model_err",
                         ROUTE_CASES)
def test_band_routes_match_jax_band_skip(problem, route, mask, dim_prior,
                                         ignore_model_err):
    """The port's one-pass and cdf routes (band order at every Ngrid)
    against JAX's with its band skip at Ngrid = 301 (three 128-column
    blocks, band-sorted models)."""
    prob = problem if mask == "masked" else _full(problem)
    kw = dict(ONEPASS if route == "onepass" else CDF, dim_prior=dim_prior,
              ignore_model_err=ignore_model_err)
    assert TF.fused_route(full_mask=mask == "full", dim_prior=dim_prior,
                          wt_thresh=None,
                          cdf_thresh=kw["cdf_thresh"]) != "screened"
    _assert_close(_port(*prob, **kw), _jax(*prob, **kw))


@pytest.mark.parametrize("route", ["onepass", "cdf"])
@pytest.mark.parametrize("ignore_model_err", [False, True])
def test_band_routes_match_jax_free_scale(route, ignore_model_err):
    """Free scale at Ngrid = 101, where JAX does not band-sort, so both
    converge the scale over the caller's model groups; the port's stacks
    read them in band order.  tests/test_torch_onepass.py's free-scale
    tolerances (IME_TOL, ME_TOL)."""
    kw = dict(ONEPASS if route == "onepass" else CDF, free_scale=True,
              ignore_model_err=ignore_model_err)
    prob = _problem(Ngrid=101)
    tol = IME_TOL if ignore_model_err else ME_TOL
    _assert_close(_port(*prob, **kw), _jax(*prob, **kw), **tol)


def test_straddling_tie_keeps_caller_order_members_apart_in_band_order(
        problem):
    """Model 0's photometry twice, the first copy (caller index 0) with
    the kernel row of the model whose support centre is highest, so the
    two tie members sort far apart and in the other order.  The top
    group straddles the cut (cdf_thresh half one member's mass): the
    reference keeps the member of lower caller index, which is the later
    one in band order.  The port's cdf route equals the XLA sorted-CDF
    result, on the top-T cut and on the bisection's."""
    d, de, dm, m, me, mm, G = _full(problem)
    centre = np.array([np.nonzero(r)[0].mean() for r in G])
    hi = int(np.argmax(centre))
    assert hi != 0 and centre[hi] > centre[0] + 50
    m2, me2 = np.concatenate([m[:1], m]), np.concatenate([me[:1], me])
    mm2, G2 = np.concatenate([mm[:1], mm]), np.concatenate([G[hi:hi + 1], G])
    d2 = d.copy()
    d2[0] = m[0] + np.sqrt(0.6 * (de[0] ** 2 + me[0] ** 2))
    bs = GK.band_sort(*_tensors(m2, me2, mm2, G2))
    pos = bs.inv.numpy()
    assert pos[0] > pos[1] + 50
    lnp = np.asarray(JL.logprob(d2, de, dm, m2, me2, mm2).lnprob)
    levid = np.asarray(jax.scipy.special.logsumexp(lnp, axis=1))
    g0 = float(np.exp(lnp[0].max() - levid[0]))
    assert lnp[0, 0] == lnp[0, 1] == lnp[0].max() and 2 * g0 < 1.0
    thr = 0.5 * g0
    wt = JK.threshold_weights(jnp.exp(lnp - levid[:, None]), None, thr)
    assert float(wt[0, 0]) > 0.0 and float(wt[0, 1]) == 0.0
    want = np.asarray(wt @ jnp.asarray(G2, jnp.float32))
    kw = dict(wt_thresh=None, cdf_thresh=thr)
    for extra in ({}, dict(cdf_topk=1, cdf_exact=True)):
        got = _port(d2, de, dm, m2, me2, mm2, G2, **kw, **extra)
        np.testing.assert_allclose(got[0], want, **CDF_PDF_TOL)


def test_free_scale_band_stacks_read_caller_order_sweep_groups(problem):
    """Free scale with model errors under a non-identity band order: the
    band-ordered lnl equals the caller-order lnl permuted, bit for bit
    (model j of the band order runs sweeps[b, perm[j] // tm]), and both
    band stacks equal the caller-order products of the same weights."""
    d, de, dm, m, me, mm, _ = problem
    rng = np.random.default_rng(5)
    M = m.shape[0]
    G = np.asarray(JK.kernel_matrix(
        rng.uniform(0, 3, M), np.full(M, 0.1), np.linspace(0, 3, 301)),
        np.float32)
    Gt, mT, meT, mmT = _tensors(m, me, mm, G)
    t = [torch.from_numpy(x) for x in (d, de, dm)]
    tm = 96
    sw = GK.scale_sweeps_plain(*t, mT, meT, mmT, tm=tm)
    assert len(set(sw.flatten().tolist())) > 3
    flags = dict(free_scale=True, sweeps=sw, tm=tm)
    bs = GK.band_sort(Gt, mT, meT, mmT)
    perm = bs.perm.long()
    assert not torch.equal(perm, torch.arange(M))
    lnl = GK.lnl_tile_plain(*t, mT, meT, mmT, **flags)
    lnl_b = GK.lnl_tile_plain(*t, bs.mT, bs.meT, bs.mmT, perm=bs.perm,
                              **flags)
    assert torch.equal(lnl_b, lnl[:, perm])
    pdf, lmap, levid = GK.lnl_onepass(*t, bs, **flags)
    assert torch.equal(lmap, lnl.amax(dim=1))
    want = torch.exp(lnl - lmap[:, None]).double() @ Gt.double()
    np.testing.assert_allclose(pdf.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-7)
    cut = lnl.quantile(0.9, dim=1)
    nan = torch.full_like(cut, torch.nan)
    got = GK.lnl_cut_stack(*t, bs, cut, levid, nan, torch.zeros_like(cut),
                           **flags)
    w = torch.where(lnl <= cut[:, None], torch.exp(lnl - levid[:, None]), 0)
    np.testing.assert_allclose(got.numpy(), (w.double() @ Gt.double())
                               .numpy(), rtol=1e-5, atol=1e-7)


def _spy_reduce(monkeypatch):
    calls = []
    orig = GK.lnl_reduce

    def spy(d, *a, **k):
        calls.append(d.shape[0])
        return orig(d, *a, **k)

    monkeypatch.setattr(GK, "lnl_reduce", spy)
    return calls


def test_table_route_chunks_follow_free_memory(problem, monkeypatch):
    """A free-memory budget of 3.5 rows of table cuts the 24-row batch
    into 8 chunks of 3 rows and changes no bit of the route's outputs; a
    budget under one row raises MemoryError (no recompute fallback)."""
    d, de, dm, m, me, mm, G = problem
    kw = dict(wt_thresh=1e-3, full_mask=False)
    want = TF.fused_fit_pdf(d, de, dm, m, me, mm, G, **kw)
    row = 4 * GK.table_width(m.shape[0])
    monkeypatch.setattr(TF, "_free_table_bytes", lambda dev: 3.5 * row)
    calls = _spy_reduce(monkeypatch)
    got = TF.fused_fit_pdf(d, de, dm, m, me, mm, G, **kw)
    assert calls == [3] * 8
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    monkeypatch.setattr(TF, "_free_table_bytes", lambda dev: row - 4)
    with pytest.raises(MemoryError, match="one row of the lnl table"):
        TF.fused_fit_pdf(d, de, dm, m, me, mm, G, **kw)


def test_free_table_bytes_reads_the_card(monkeypatch):
    """On a card: mem_get_info's free bytes and the allocator's unused
    cached bytes, less TABLE_MARGIN; no cap on the CPU.  The card's
    queries are monkeypatched (no card here)."""
    gib = 2 ** 30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (5 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda dev=None: 3 * gib)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda dev=None: 2 * gib)
    assert TF._free_table_bytes(torch.device("cuda", 0)) \
        == 6 * gib - TF.TABLE_MARGIN
    assert TF._free_table_bytes(torch.device("cpu")) is None
    # 5 GiB of budget: a 65,536 x 100,000 batch's 26 GB table in chunks.
    rows = GK.table_rows(65_536, 100_000, budget=5 * gib)
    assert rows * 4 * GK.table_width(100_000) <= 5 * gib
    assert -(-65_536 // rows) == 5


TABLE_CASES = [(mask, dp, ime) for mask in ("masked", "full")
               for dp in (True, False) for ime in (False, True)
               # full masks + dim prior + fixed scale: the screened route
               if not (mask == "full" and dp)]


def _spy(monkeypatch, module, name):
    """Record the calls of `module.name` (their keywords) and pass them
    on."""
    calls = []
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append(k)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("mask,dim_prior,ignore_model_err", TABLE_CASES)
def test_table_route_matches_jax_band_skip(problem, monkeypatch, mask,
                                           dim_prior, ignore_model_err):
    """The `wt_thresh` table route over the models in band order (the
    producer on the sorted models, `lnl_stack_band` reading the table)
    against JAX's route with its band skip at Ngrid = 301, where JAX
    band-sorts the masked route's models (ops/fused.py:1863-1872)."""
    prob = problem if mask == "masked" else _full(problem)
    kw = dict(wt_thresh=1e-3, dim_prior=dim_prior,
              ignore_model_err=ignore_model_err)
    assert TF.fused_route(full_mask=mask == "full", dim_prior=dim_prior,
                          wt_thresh=1e-3) == "general"
    band = _spy(monkeypatch, GK, "lnl_stack_band")
    dense = _spy(monkeypatch, GK, "lnl_stack")
    _assert_close(_port(*prob, **kw), _jax(*prob, **kw))
    assert len(band) == 1 and not dense


@pytest.mark.parametrize("ignore_model_err", [True, False])
def test_table_route_matches_jax_free_scale(monkeypatch, ignore_model_err):
    """Free scale on the table route: without model errors in band order
    at Ngrid = 301, as JAX sorts; with model errors at Ngrid = 101, where
    JAX keeps the caller's convergence groups, as the port's table does.
    tests/test_torch_onepass.py's free-scale tolerances."""
    prob = _problem(Ngrid=301 if ignore_model_err else 101)
    kw = dict(wt_thresh=1e-3, free_scale=True,
              ignore_model_err=ignore_model_err)
    band = _spy(monkeypatch, GK, "lnl_stack_band")
    tol = IME_TOL if ignore_model_err else ME_TOL
    _assert_close(_port(*prob, **kw), _jax(*prob, **kw), **tol)
    assert len(band) == int(ignore_model_err)


def test_free_scale_with_model_errors_keeps_the_caller_order_table(
        problem, monkeypatch):
    """Under free scale with model errors `scale_sweeps` writes the lnl
    table over the caller's convergence groups: no band sort, and
    `lnl_stack` reads the table in the caller's order, bit for bit the
    recompute route on the caller's models.  Without model errors the
    same call sorts once and reads the table with `lnl_stack_band`."""
    d, de, dm, m, me, mm, G = problem
    tm = 128
    sorts = _spy(monkeypatch, TF, "band_sort")
    band = _spy(monkeypatch, GK, "lnl_stack_band")
    dense = _spy(monkeypatch, GK, "lnl_stack")
    got = TF.fused_fit_pdf(d, de, dm, m, me, mm, G, free_scale=True,
                           wt_thresh=1e-3, tm=tm)
    assert not sorts and not band
    assert len(dense) == 1 and dense[0]["table"] is not None
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (d, de, dm, m.T, me.T, mm.T)]
    sw = GK.scale_sweeps(*t, tm=tm, full_mask=False)
    flags = dict(free_scale=True, sweeps=sw, tm=tm)
    lmap, levid = GK.lnl_reduce_plain(*t, **flags)
    pdf = GK.lnl_stack_plain(*t, torch.from_numpy(G), lmap, levid,
                             log_thr=float(np.log(1e-3)), **flags)
    good = lmap > GK.NEG_INF / 2
    for g, w in zip(got, (torch.where(good[:, None], pdf, 0.0), lmap,
                          levid)):
        assert torch.equal(g, w)
    TF.fused_fit_pdf(d, de, dm, m, me, mm, G, free_scale=True,
                     ignore_model_err=True, wt_thresh=1e-3)
    assert len(sorts) == 1 and len(band) == 1 and len(dense) == 1


@pytest.mark.parametrize("wt_thresh", [1e-3, None])
@pytest.mark.parametrize("ignore_model_err", [False, True])
def test_k1_pair_matches_jax_band_skip(problem, monkeypatch, wt_thresh,
                                       ignore_model_err):
    """The K1 pair (``screen=False``, full masks, dim prior, fixed scale)
    over the models in band order, `chi2_stack` given the tiles' bands,
    against JAX's pair with its band skip at Ngrid = 301
    (ops/fused.py:1701-1704)."""
    from frankenz_tpu_torch.kernels import fullmask as FM

    prob = _full(problem)
    kw = dict(wt_thresh=wt_thresh, cdf_thresh=None,
              ignore_model_err=ignore_model_err)
    assert TF.fused_route(full_mask=True, wt_thresh=wt_thresh,
                          screen=False) == "fullmask"
    stacks = _spy(monkeypatch, FM, "chi2_stack")
    _assert_close(_port(*prob, screen=False, **kw), _jax(*prob, **kw))
    assert len(stacks) == 1 and stacks[0]["bands"] is not None
