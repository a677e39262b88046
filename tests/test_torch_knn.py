"""Port parity for the NearestNeighbors (KMCkNN) fitter.

The same NumPy inputs go through `frankenz_tpu`'s NearestNeighbors (on
the CPU, x64) and the port's (on CPU tensors).  Both draw the feature
ensembles and the query jitter from one `numpy.random.Generator` seed, so
the constructor's features, the neighbour lists and every fit grid are
compared directly.  Tolerances: features 1e-6 relative (float32); the
search equal element for element, except rows where `knn._near_ties`
finds two candidates within 1e-5 of each other (on the scale at which
float32 rounds the distance): there only those candidates may swap, and
fewer than 1% of rows may need it; fit grids, PDFs, lmap and levid 1e-6
(the plain-path tolerance); summaries rtol 2e-5 / atol 2e-6.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from frankenz_tpu import ops as JOPS
from frankenz_tpu.models import NearestNeighbors as JaxNN
from frankenz_tpu.models import knn as JKNN
from frankenz_tpu.ops import PDFDict as JaxPDFDict
from frankenz_tpu_torch.models import NearestNeighbors
from frankenz_tpu_torch.models import knn as TKNN
from frankenz_tpu_torch.ops import likelihood as TL
from frankenz_tpu_torch.utils import knn_from_jax, pdfdict_from

TOL = dict(rtol=1e-6, atol=1e-9)
SUMMARY_TOL = dict(rtol=2e-5, atol=2e-6)
FITS = ("fit_lnprior", "fit_lnlike", "fit_lnprob", "fit_Ndim", "fit_chi2",
        "fit_scale", "fit_scale_err")


@pytest.fixture(scope="module")
def problem():
    """tests/test_knn.py's problem at 317 models and 37 objects (a ragged
    last batch at batch_size 16)."""
    rng = np.random.default_rng(11)
    nmodel, nobj, nfilt = 317, 37, 5
    models = rng.uniform(1, 10, (nmodel, nfilt))
    models_err = 0.02 * models
    models_mask = np.ones_like(models)
    zlab = rng.uniform(0, 3, nmodel)
    zerr = np.full(nmodel, 0.1)
    truth = rng.integers(0, nmodel, nobj)
    data = models[truth] + rng.normal(0, 0.05, (nobj, nfilt))
    data_err = np.full((nobj, nfilt), 0.05)
    data_mask = np.ones_like(data)
    return dict(models=models, models_err=models_err,
                models_mask=models_mask, data=data, data_err=data_err,
                data_mask=data_mask, zlab=zlab, zerr=zerr)


def _pair(problem, K=4, seed=3, **kw):
    mods = (problem["models"], problem["models_err"], problem["models_mask"])
    return (JaxNN(*mods, K=K, seed=seed, verbose=False, **kw),
            NearestNeighbors(*mods, K=K, seed=seed, verbose=False,
                             device="cpu", **kw))


def _data(problem):
    return problem["data"], problem["data_err"], problem["data_mask"]


def assert_neighbors(got, want, q, feats, k, lp_norm=2):
    """Neighbour lists equal row for row, but for rows with a near tie,
    where only near-equal candidates may differ; < 1% of rows may."""
    got, want = np.asarray(got), np.asarray(want)
    ties, cands = TKNN._near_ties(torch.as_tensor(np.array(q)),
                                 torch.as_tensor(np.array(feats)), k,
                                 lp_norm=lp_norm)
    ties, cands = ties.numpy(), cands.numpy()
    diff = np.nonzero((got != want).any(axis=1))[0]
    for b in diff:
        assert ties[b], f"row {b} differs without a near tie"
        a, w = set(got[b][got[b] >= 0]), set(want[b][want[b] >= 0])
        assert all(cands[b][m] for m in a ^ w), \
            f"row {b} differs outside its near ties"
    assert len(diff) < 0.01 * len(got), f"rows {diff.tolist()} differ"


@pytest.mark.parametrize("feature_map", ["luptitude", "magnitude",
                                         "identity"])
def test_features_match_jax(problem, feature_map):
    a, b = _pair(problem, feature_map=feature_map)
    fa, fb = np.asarray(a.features), b.features.numpy()
    assert fb.dtype == np.float32 and fb.shape == fa.shape
    np.testing.assert_allclose(fb, fa, rtol=1e-6, atol=0)
    np.testing.assert_allclose(b.features_sqnorm.numpy(),
                               np.asarray(a.features_sqnorm), rtol=1e-6)
    # The model set keeps its dtype.
    assert b.models.dtype == torch.float64


SEARCH_CASES = {
    "one_chunk": dict(lp_norm=2, dbound=np.inf, chunked=False),
    "chunked": dict(lp_norm=2, dbound=np.inf, chunked=True),
    "lp1": dict(lp_norm=1, dbound=np.inf, chunked=False),
    "lp1_chunked": dict(lp_norm=1, dbound=np.inf, chunked=True),
    "bound": dict(lp_norm=2, dbound=0.05, chunked=False),
    "bound_chunked": dict(lp_norm=2, dbound=0.05, chunked=True),
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_matches_jax(problem, monkeypatch, case):
    """The same query features through both searches (the port holding
    JAX's ensembles via `knn_from_jax`); chunked: 317 model columns in
    3 chunks of 128, forced by the distance-block byte ceiling."""
    cfg = SEARCH_CASES[case]
    a, _ = _pair(problem, K=4, seed=5)
    b = knn_from_jax(a, "cpu")
    rng = np.random.default_rng(2)
    d, de, _ = _data(problem)
    q = np.asarray(a.feature_map(jnp.asarray(
        rng.normal(d, de), jnp.float32), jnp.asarray(de, jnp.float32))[0],
        np.float32)
    k = 5
    if cfg["chunked"]:
        nbytes = 4 * len(q) * 130
        for mod in (JKNN, TKNN):
            monkeypatch.setattr(mod, "_TOPK_DIST_BYTES", nbytes)
        assert TKNN._topk_chunk_cols(len(q), k) == 128
    jidx, jvalid, jn = a._search_fn(k, cfg["lp_norm"], cfg["dbound"])(
        jnp.asarray(q), a.features, a.features_sqnorm)
    tidx, tvalid, tn = b._search_fn(k, cfg["lp_norm"], cfg["dbound"])(q)
    assert_neighbors(tidx.numpy(), np.asarray(jidx), q, b.features, k,
                     cfg["lp_norm"])
    same = (tidx.numpy() == np.asarray(jidx)).all(axis=1)
    np.testing.assert_array_equal(tn.numpy()[same], np.asarray(jn)[same])
    np.testing.assert_array_equal(tvalid.numpy()[same],
                                  np.asarray(jvalid)[same])
    if np.isfinite(cfg["dbound"]):
        assert (tn.numpy() < b.K * k).any()  # the bound removed some


def test_distance_bound_does_not_shadow_inbound_neighbor():
    """tests/test_knn.py's case on both searches: ensemble 0 sees model
    0 out of bound, ensemble 1 in bound; the in-bound one survives."""
    feats = np.asarray([[[3.0], [10.0]], [[1.0], [10.0]]], np.float32)
    fsq = (feats * feats).sum(-1)
    q = np.zeros((1, 1), np.float32)
    jout = JKNN._search_jit(jnp.asarray(q), jnp.asarray(feats),
                            jnp.asarray(fsq), K=2, k=1, lp_norm=2,
                            dbound=2.0, approx=False)
    tout = TKNN._search(torch.as_tensor(q), torch.as_tensor(feats),
                        torch.as_tensor(fsq), K=2, k=1, lp_norm=2,
                        dbound=2.0)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tout[0].tolist() == [[0, -99]] and int(tout[2][0]) == 1


@pytest.mark.parametrize("chunked", [False, True])
def test_exact_ties_take_the_lowest_index(monkeypatch, chunked):
    """64 models repeated 4 times with zero errors: every query sits on a
    model, its group ties at distance 0 and the next group ties across
    the k-th place; both packages take the lowest indices first."""
    rng = np.random.default_rng(3)
    base = rng.uniform(5.0, 50.0, (64, 5))
    mt = np.tile(base, (4, 1))
    zeros, ones = np.zeros_like(mt), np.ones_like(mt)
    a = JaxNN(mt, zeros, ones, K=3, seed=0, verbose=False)
    b = NearestNeighbors(mt, zeros, ones, K=3, seed=0, verbose=False,
                         device="cpu")
    if chunked:
        for mod in (JKNN, TKNN):
            monkeypatch.setattr(mod, "_TOPK_DIST_BYTES", 4 * 16 * 130)
    q = b.features[0][:16].numpy()
    jidx = np.asarray(a._search_fn(6, 2, np.inf)(
        jnp.asarray(q), a.features, a.features_sqnorm)[0])
    tidx = b._search_fn(6, 2, np.inf)(q)[0].numpy()
    f64 = b.features[0].numpy().astype(float)
    for r in range(16):
        dist = ((f64 - f64[r]) ** 2).sum(axis=1)
        want = np.argsort(dist, kind="stable")[:6].tolist()
        assert want[:4] == [r, r + 64, r + 128, r + 192]
        assert tidx[r][:6].tolist() == want
        assert (tidx[r][6:] == -99).all()
    np.testing.assert_array_equal(tidx, jidx)


def _jax_prior_lprob(d, de, dm, m, me, mm, **kw):
    res = JOPS.logprob(d, de, dm, m, me, mm, **kw)
    lnprior = res[1] * 0.0 - 0.5 * jnp.square(m[..., 0] - 5.0) / 4.0
    return (lnprior, res[1], res[1] + lnprior, res[3], res[4])


def _torch_prior_lprob(d, de, dm, m, me, mm, **kw):
    res = TL.logprob(d, de, dm, m, me, mm, **kw)
    lnprior = res[1] * 0.0 - 0.5 * torch.square(m[..., 0] - 5.0) / 4.0
    return (lnprior, res[1], res[1] + lnprior, res[3], res[4])


FIT_CASES = {
    "grid": dict(),
    "dict": dict(use_dict=True),
    "track_scale_free": dict(track_scale=True, lprob_kwargs=dict(
        free_scale=True, return_scale=True)),
    "custom_lprob": dict(custom=True),
    "cdf_thresh": dict(wt_thresh=None),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_predict_matches_jax(problem, case):
    """fit_predict(save_fits=True) on both packages: the neighbour lists,
    every fit grid, PDFs, lmap and levid; then fit + predict on the port
    equal to its fit_predict."""
    cfg = dict(FIT_CASES[case])
    a, b = _pair(problem, K=4, seed=7)
    grid = np.linspace(0, 3, 101)
    common = dict(k=5, verbose=False, save_fits=True, return_gof=True,
                  batch_size=16, track_scale=cfg.get("track_scale", False),
                  lprob_kwargs=cfg.get("lprob_kwargs"))
    if "wt_thresh" in cfg:
        common["wt_thresh"] = cfg["wt_thresh"]
    jkw, tkw = dict(common), dict(common)
    if cfg.get("use_dict"):
        pd = JaxPDFDict(grid, np.linspace(0.02, 0.3, 40))
        jkw["label_dict"], tkw["label_dict"] = pd, pdfdict_from(pd)
    else:
        jkw["label_grid"] = tkw["label_grid"] = grid
    if cfg.get("custom"):
        jkw["lprob_func"], tkw["lprob_func"] = (_jax_prior_lprob,
                                                _torch_prior_lprob)
    args = _data(problem) + (problem["zlab"], problem["zerr"])
    want = a.fit_predict(*args, rng=np.random.default_rng(5), **jkw)
    got = b.fit_predict(*args, rng=np.random.default_rng(5), **tkw)
    np.testing.assert_array_equal(b.neighbors, a.neighbors)
    np.testing.assert_array_equal(b.Nneighbors, a.Nneighbors)
    for name in FITS:
        va, vb = getattr(a, name), getattr(b, name)
        if va is None:
            assert vb is None, name
            continue
        np.testing.assert_allclose(vb, va, **TOL, err_msg=name)
    if cfg.get("track_scale"):
        assert b.fit_scale is not None
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1][0], want[1][0], **TOL)
    np.testing.assert_allclose(got[1][1], want[1][1], **TOL)

    # fit then predict on both packages (the same draws); equal to
    # fit_predict too, except under the cdf rule: it drops the largest
    # weights, so the float32 stored fits move rows that the float64 grid
    # of fit_predict puts on the other side (in both packages).
    fkw = dict(rng=np.random.default_rng(5), k=5, verbose=False,
               batch_size=16, track_scale=common["track_scale"],
               lprob_kwargs=common["lprob_kwargs"])
    a.fit(*_data(problem), lprob_func=jkw.get("lprob_func"), **fkw)
    fkw["rng"] = np.random.default_rng(5)
    b.fit(*_data(problem), lprob_func=tkw.get("lprob_func"), **fkw)
    np.testing.assert_array_equal(b.neighbors, a.neighbors)
    pkw = {key: tkw[key] for key in ("label_grid", "label_dict",
                                     "wt_thresh") if key in tkw}
    two = b.predict(problem["zlab"], problem["zerr"], return_gof=True,
                    **pkw)
    pkw.update({key: jkw[key] for key in ("label_dict",) if key in jkw})
    two_jax = a.predict(problem["zlab"], problem["zerr"], return_gof=True,
                        verbose=False, **pkw)
    fused = (got,) if cfg.get("wt_thresh", 1e-3) is not None else ()
    for ref in (two_jax,) + fused:
        np.testing.assert_allclose(two[0], ref[0], **TOL)
        np.testing.assert_allclose(two[1][0], ref[1][0], **TOL)
        np.testing.assert_allclose(two[1][1], ref[1][1], **TOL)


def test_fit_summarize_matches_jax(problem):
    a, b = _pair(problem, K=3, seed=9)
    grid = np.linspace(0, 3, 101)
    args = _data(problem) + (problem["zlab"], problem["zerr"])
    kw = dict(label_grid=grid, k=5, verbose=False, batch_size=16)
    sa, ga = a.fit_summarize(*args, rng=np.random.default_rng(4), **kw)
    sb, gb = b.fit_summarize(*args, rng=np.random.default_rng(4), **kw)
    for est_a, est_b in zip(sa[:4], sb[:4]):
        for x, y in zip(est_a, est_b):
            np.testing.assert_allclose(np.asarray(y), np.asarray(x),
                                       **SUMMARY_TOL)
    for x, y in zip(sa[4:], sb[4:]):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x),
                                   **SUMMARY_TOL)
    np.testing.assert_allclose(gb[0], ga[0], **TOL)
    np.testing.assert_allclose(gb[1], ga[1], **TOL)


def test_approx_is_the_exact_search(problem):
    _, b = _pair(problem, K=3, seed=2)
    args = _data(problem) + (problem["zlab"], problem["zerr"])
    kw = dict(label_grid=np.linspace(0, 3, 101), k=5, verbose=False,
              return_gof=True, save_fits=True)
    exact = b.fit_predict(*args, rng=np.random.default_rng(1), **kw)
    nb = b.neighbors.copy()
    approx = b.fit_predict(*args, rng=np.random.default_rng(1),
                           approx=True, **kw)
    np.testing.assert_array_equal(approx[0], exact[0])
    np.testing.assert_array_equal(approx[1][0], exact[1][0])
    np.testing.assert_array_equal(approx[1][1], exact[1][1])
    np.testing.assert_array_equal(b.neighbors, nb)


def test_shared_rng_streams_stay_equal(problem):
    """Two calls sharing the constructor's generator (rng=None): the
    padded batches' zero-scale draws consume the stream as in JAX, so
    both calls match JAX's two calls."""
    a, b = _pair(problem, K=3, seed=21)
    args = _data(problem) + (problem["zlab"], problem["zerr"])
    kw = dict(label_grid=np.linspace(0, 3, 101), k=5, verbose=False,
              return_gof=True, batch_size=16)
    for n in (37, 21):
        sub = tuple(x[:n] for x in args[:3]) + args[3:]
        want = a.fit_predict(*sub, **kw)
        got = b.fit_predict(*sub, **kw)
        np.testing.assert_allclose(got[0], want[0], **TOL)
        np.testing.assert_allclose(got[1][0], want[1][0], **TOL)
    assert a.rng.random() == b.rng.random()


def test_fit_predict_counts_its_work(problem):
    """The telemetry counters and timer of the JAX fitter, in the port's
    registry."""
    from frankenz_tpu_torch.utils import metrics
    _, b = _pair(problem, K=3, seed=1)
    metrics.reset()
    b.fit_predict(*_data(problem), problem["zlab"], problem["zerr"],
                  label_grid=np.linspace(0, 3, 101), k=5, verbose=False)
    n = len(problem["data"])
    assert metrics.counters == {"knn_search_pairs": n * 3 * b.NMODEL,
                                "chi2_pair_evals": n * 3 * 5,
                                "pdf_stacks": n}
    assert metrics.timings["knn.fit_predict"]["n"] == 1
    metrics.reset()


def test_knn_from_jax_carries_the_fits(problem):
    """A port fitter built from a fitted JAX one: JAX's predict output
    from the carried fits, and JAX's fit_predict output from the same
    generator state."""
    a, _ = _pair(problem, K=4, seed=13)
    grid = np.linspace(0, 3, 101)
    a.fit(*_data(problem), rng=np.random.default_rng(8), k=5,
          verbose=False)
    b = knn_from_jax(a, "cpu")
    assert b.K == a.K and b.k == 5 and b.NDATA == a.NDATA
    np.testing.assert_array_equal(b.neighbors, a.neighbors)
    want = a.predict(problem["zlab"], problem["zerr"], label_grid=grid,
                     return_gof=True, verbose=False)
    got = b.predict(problem["zlab"], problem["zerr"], label_grid=grid,
                    return_gof=True)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1][0], want[1][0], **TOL)
    args = _data(problem) + (problem["zlab"], problem["zerr"])
    kw = dict(label_grid=grid, k=5, verbose=False, return_gof=True)
    want = a.fit_predict(*args, **kw)
    got = b.fit_predict(*args, **kw)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1][1], want[1][1], **TOL)


def test_unported_options_raise(problem):
    """The mesh= refusals of the JAX fitter (knn.py:623-625) and a mesh
    that is not a `parallel.Mesh`."""
    from frankenz_tpu_torch.parallel import make_mesh

    _, b = _pair(problem, K=2, seed=0)
    args = _data(problem) + (problem["zlab"], problem["zerr"])
    grid = np.linspace(0, 3, 11)
    with pytest.raises(TypeError, match="Mesh"):
        b.fit_predict(*args, label_grid=grid, mesh=object())
    with pytest.raises(ValueError, match="save_fits"):
        b.fit_predict(*args, label_grid=grid, save_fits=True,
                      mesh=make_mesh(devices=["cpu"] * 2))
    # Checkpoints are ported: a plan without a file fails fast.
    with pytest.raises(ValueError, match="checkpoint_file"):
        b.fit(*_data(problem), checkpoint_every=1)


def test_cuda_device_raises_without_a_card(problem):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mods = (problem["models"], problem["models_err"], problem["models_mask"])
    with pytest.raises(RuntimeError, match="CUDA"):
        NearestNeighbors(*mods, K=2)
