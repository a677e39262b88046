"""Port parity for the gathered KDE ops and the kNN pieces the network
fitters share.

The same NumPy inputs go through `frankenz_tpu.ops.kde` /
`frankenz_tpu.models.knn` and their ports (CPU tensors).  Tolerances:
PDF cells rtol 2e-3 / atol 2e-5 where the two stack products may
round differently, else 1e-6 relative (the same float64 arithmetic);
the gathered posteriors 1e-6 relative, their padding exact.
"""

import numpy as np
import pytest
import torch

from _torch_port import to_numpy
from frankenz_tpu.models import knn as JKNN
from frankenz_tpu.ops import kde as JK
from frankenz_tpu.ops import likelihood as JL
from frankenz_tpu_torch.models import knn as TKNN
from frankenz_tpu_torch.ops import kde as TK
from frankenz_tpu_torch.ops import likelihood as TL
from frankenz_tpu_torch.utils import pdfdict_from

TIGHT = dict(rtol=1e-6, atol=1e-12)
PDF_TOL = dict(rtol=2e-3, atol=2e-5)


@pytest.fixture(scope="module")
def gathered():
    rng = np.random.default_rng(12)
    B, J, M = 9, 23, 60
    grid = np.linspace(0, 3, 101)
    pd = JK.PDFDict(grid, np.linspace(0.02, 0.4, 25))
    y = rng.uniform(-0.2, 3.2, M)
    ys = rng.uniform(0.02, 0.5, M)
    idx = rng.integers(0, M, (B, J))
    wts = rng.uniform(0, 1, (B, J))
    wts[:, -4:] = 0.0
    wts[3] = 0.0
    fp, fs = (np.asarray(a) for a in pd.fit(y, ys))
    return dict(grid=grid, pd=pd, tpd=pdfdict_from(pd), y=y, ys=ys, idx=idx,
                wts=wts, fp=fp, fs=fs)


def test_gaussian_bin_matches_jax():
    bins = np.linspace(-1, 4, 57)
    mu = np.array([[0.3], [1.7], [2.2]])
    std = np.array([[0.1], [0.4], [1.5]])
    want = to_numpy(JK.gaussian_bin(mu, std, bins))
    got = to_numpy(TK.gaussian_bin(mu, std, bins))
    assert got.shape == (3, 56)
    np.testing.assert_allclose(got, want, **TIGHT)


def test_kde_stack_gathered_dict_matches_jax(gathered, monkeypatch):
    g = gathered
    pos, sig = g["fp"][g["idx"]], g["fs"][g["idx"]]
    want = to_numpy(JK.kde_stack_gathered_dict(g["pd"], pos, sig, g["wts"]))
    got = to_numpy(TK.kde_stack_gathered_dict(g["tpd"], pos, sig, g["wts"]))
    np.testing.assert_allclose(got, want, **TIGHT)
    assert np.all(got[3] == 0.0)
    # Object chunks (here 2 rows at a time) change no result.
    monkeypatch.setattr(TK, "GATHER_ELEMS", 2 * 23 * 101)
    chunked = to_numpy(TK.kde_stack_gathered_dict(g["tpd"], pos, sig,
                                                  g["wts"]))
    np.testing.assert_array_equal(chunked, got)


@pytest.mark.parametrize("dx,sig_thresh", [(None, 5.0), (0.05, 3.0)])
def test_kde_stack_gathered_grid_matches_jax(gathered, dx, sig_thresh):
    g = gathered
    y, ys = g["y"][g["idx"]], g["ys"][g["idx"]]
    want = to_numpy(JK.kde_stack_gathered(y, ys, g["wts"], g["grid"], dx=dx,
                                          sig_thresh=sig_thresh))
    got = to_numpy(TK.kde_stack_gathered(y, ys, g["wts"], g["grid"], dx=dx,
                                         sig_thresh=sig_thresh))
    np.testing.assert_allclose(got, want, **TIGHT)


@pytest.mark.parametrize("use_dict", [True, False])
def test_pack_label_spec_matches_jax(gathered, use_dict):
    g = gathered
    jd, td = (g["pd"], g["tpd"]) if use_dict else (None, None)
    want = JK.pack_label_spec(jd, None if use_dict else g["grid"], g["y"],
                              g["ys"])
    got = TK.pack_label_spec(td, None if use_dict else g["grid"], g["y"],
                             g["ys"])
    assert got[:2] == want[:2]
    for a, b in zip(got[2], want[2]):
        np.testing.assert_allclose(np.asarray(to_numpy(a), float),
                                   np.asarray(b, float), **TIGHT)
    with pytest.raises(ValueError, match="label_grid"):
        TK.pack_label_spec(None, None, g["y"], g["ys"])


@pytest.mark.parametrize("batched", [False, True])
def test_gauss_kde_matches_jax(gathered, batched):
    g = gathered
    wt = g["wts"][:, :20] if batched else g["wts"][0, :20]
    args = (g["y"][:20], g["ys"][:20], g["grid"])
    want = to_numpy(JK.gauss_kde(*args, y_wt=wt))
    got = to_numpy(TK.gauss_kde(*args, y_wt=wt))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **PDF_TOL)
    np.testing.assert_allclose(to_numpy(TK.gauss_kde(*args)),
                               to_numpy(JK.gauss_kde(*args)), **PDF_TOL)


@pytest.mark.parametrize("by_index", [False, True])
def test_gauss_kde_dict_matches_jax(gathered, by_index):
    g = gathered
    if by_index:
        kw = dict(y_idx=g["fp"][:20], y_std_idx=g["fs"][:20])
    else:
        kw = dict(y=g["y"][:20], y_std=g["ys"][:20])
    want = to_numpy(JK.gauss_kde_dict(g["pd"], y_wt=g["wts"][:, :20], **kw))
    got = to_numpy(TK.gauss_kde_dict(g["tpd"], y_wt=g["wts"][:, :20], **kw))
    np.testing.assert_allclose(got, want, **PDF_TOL)
    np.testing.assert_allclose(to_numpy(TK.gauss_kde_dict(g["tpd"], **kw)),
                               to_numpy(JK.gauss_kde_dict(g["pd"], **kw)),
                               **PDF_TOL)


@pytest.fixture(scope="module")
def union_problem():
    rng = np.random.default_rng(21)
    B, J, M, F = 11, 17, 80, 4
    m = rng.uniform(1, 10, (M, F))
    me = 0.05 * m
    mm = (rng.uniform(size=(M, F)) > 0.15).astype(float)
    d = m[rng.integers(0, M, B)] * rng.uniform(0.7, 1.4, (B, 1)) \
        + rng.normal(0, 0.2, (B, F))
    de = np.full((B, F), 0.2)
    dm = np.ones((B, F))
    dm[1, 2] = 0.0
    idx = rng.integers(0, M, (B, J))
    idx[:, -5:] = -99
    return d, de, dm, idx, m, me, mm


def _jax_custom(*a, **k):
    return JL.logprob(*a, **k)


def _torch_custom(*a, **k):
    return TL.logprob(*a, **k)


@pytest.mark.parametrize("kwargs,custom", [
    ({}, False),
    ({"free_scale": True}, False),
    ({"free_scale": True, "ignore_model_err": True, "return_scale": True},
     False),
    ({"dim_prior": False}, False),
    ({"free_scale": True, "ignore_model_err": True, "return_scale": True},
     True),
])
def test_gathered_lprob_matches_jax(union_problem, kwargs, custom):
    """Each object against its own gathered models, as the JAX vmap of
    single-object calls; a custom lprob goes through `torch.func.vmap`."""
    d, de, dm, idx, m, me, mm = union_problem
    valid = idx >= 0
    want = JKNN._gathered_lprob_jit(
        d, de, dm, idx, valid, m, me, mm,
        lprob_spec=JL.static_spec(_jax_custom if custom else None, (),
                                  kwargs))
    got = TKNN._gathered_lprob(
        *(torch.tensor(a) for a in (d, de, dm, idx, valid, m, me, mm)),
        lprob_spec=TL.static_spec(_torch_custom if custom else None, (),
                                  kwargs))
    for k, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        g, w = to_numpy(g), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w)
        np.testing.assert_array_equal(g[~fin], w[~fin])
        np.testing.assert_allclose(g[fin], w[fin], **TIGHT, err_msg=str(k))
    assert np.all(to_numpy(got[2])[~valid] == -np.inf)


@pytest.mark.parametrize("lab", ["grid", "dict"])
@pytest.mark.parametrize("cdf", [False, True])
def test_stack_batches_matches_jax(gathered, lab, cdf):
    g = gathered
    rng = np.random.default_rng(3)
    logwt = rng.normal(0, 2, g["idx"].shape).astype(np.float32)
    nbr = g["idx"].copy()
    nbr[:, -3:] = -99
    logwt[:, -3:] = -np.inf
    thr = (None, 2e-4) if cdf else (1e-3, 2e-4)
    jd, td = (g["pd"], g["tpd"]) if lab == "dict" else (None, None)
    lgrid = None if lab == "dict" else g["grid"]
    want = JKNN.NearestNeighbors._stack_batches(
        None, logwt, nbr, g["y"], g["ys"], jd, lgrid, *thr, 4)
    got = TKNN.stack_batches(logwt, nbr, g["y"], g["ys"], td, lgrid, *thr, 4)
    np.testing.assert_allclose(got[0], want[0], **PDF_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    np.testing.assert_array_equal(got[3], want[3])
    lm, lv, wt = TKNN._gof_weights(torch.tensor(logwt))
    np.testing.assert_allclose(wt.sum(dim=1).numpy(), 1.0, rtol=1e-5)
