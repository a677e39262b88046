"""Port parity: likelihood, KDE, summaries and utils of frankenz_tpu_torch.

(b) The likelihood in float64 against the NumPy oracle at <= 1e-6, the
    JAX package's own bar (tests/test_likelihood.py).
(c) KDE and summary functions against the JAX package on the same inputs:
    kernel matrices at 1e-12 (float64 on both sides, the same formula),
    thresholding exactly, summaries at 2e-5 relative (float32 cumsum /
    interpolation in another order; JAX promotes the quantile levels to
    float64 under x64).
"""

import numpy as np
import pytest
import torch

import _oracle as O
from _torch_port import run_both, to_numpy
from frankenz_tpu.ops import kde as JK
from frankenz_tpu.ops import summarize as JS
from frankenz_tpu_torch.ops import kde as TK
from frankenz_tpu_torch.ops import likelihood as TL
from frankenz_tpu_torch.ops import summarize as TS
from frankenz_tpu_torch.utils import Metrics, pdfdict_from, progress_iter


@pytest.fixture(scope="module")
def photometry():
    rng = np.random.default_rng(11)
    B, M, F = 13, 57, 5
    m = rng.uniform(1, 10, (M, F))
    me = 0.05 * m
    mm = (rng.uniform(size=(M, F)) > 0.2).astype(float)
    d = m[rng.integers(0, M, B)] + rng.normal(0, 0.3, (B, F))
    de = np.full((B, F), 0.3)
    dm = (rng.uniform(size=(B, F)) > 0.2).astype(float)
    dm[:, :2] = 1.0
    mm[:, :2] = 1.0
    return d, de, dm, m, me, mm


@pytest.mark.parametrize("dim_prior", [True, False])
@pytest.mark.parametrize("ignore_model_err", [False, True])
def test_loglike_fixed_matches_oracle_f64(photometry, dim_prior,
                                          ignore_model_err):
    kw = dict(ignore_model_err=ignore_model_err, dim_prior=dim_prior)
    got = TL.loglike_fixed(*(torch.from_numpy(x) for x in photometry), **kw)
    want = O.loglike(*photometry, **kw)
    assert got.lnlike.dtype == torch.float64
    for g, w in zip(got[:3], want):
        g = g.numpy()
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-6, atol=1e-6)


def test_logprob_cleans_bad_bands_and_floors_zero_overlap(photometry):
    d, de, dm, m, me, mm = (x.copy() for x in photometry)
    d[0, 3] = np.nan
    de[1, 4] = -1.0
    dm[2] = 0.0  # zero overlap with every model: lnl = -inf, not NaN
    got = TL.logprob(*(torch.from_numpy(x) for x in (d, de, dm, m, me, mm)))
    with np.errstate(invalid="ignore"):  # the oracle's NaN for Ndim == 0
        want = O.loglike(d, de, dm, m, me, mm)
    lnl = got.lnprob.numpy()
    assert np.all(lnl[2] == -np.inf)
    assert np.all(got.lnprior.numpy() == 0.0)
    ok = np.isfinite(want[0])
    np.testing.assert_allclose(lnl[ok], want[0][ok], rtol=1e-6, atol=1e-6)
    assert not np.isnan(lnl).any()


@pytest.mark.parametrize("fn", ["kernel_matrix", "kernel_matrix_dict",
                                "clean_data", "loglike_fixed",
                                "loglike_free", "loglike", "logprob"])
def test_host_inputs_go_to_the_card_and_raise_without_one(photometry, fn,
                                                          monkeypatch):
    """As JAX runs on its default device, the `ops` functions put host
    arrays on the card unless told otherwise; with no card that raises
    rather than falling back.  CPU tensors, or device="cpu", stay on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid = np.linspace(0, 3, 31)
    pd = TK.PDFDict(grid, np.linspace(0.01, 0.5, 10))
    y, ys = np.linspace(0.1, 2.9, 7), np.full(7, 0.1)
    if fn == "kernel_matrix":
        call = lambda **kw: TK.kernel_matrix(y, ys, grid, **kw)  # noqa: E731
        on_cpu = lambda: TK.kernel_matrix(  # noqa: E731
            torch.from_numpy(y), ys, grid)
    elif fn == "kernel_matrix_dict":
        idx = pd.fit(y, ys)
        call = lambda **kw: TK.kernel_matrix_dict(pd, *idx, **kw)  # noqa: E731
        on_cpu = lambda: TK.kernel_matrix_dict(  # noqa: E731
            pd, *(torch.from_numpy(np.asarray(i)) for i in idx))
    else:
        f = getattr(TL, fn)
        args = photometry[:3] if fn == "clean_data" else photometry
        call = lambda: f(*args)  # noqa: E731
        on_cpu = lambda: f(*(torch.from_numpy(x) for x in args))  # noqa: E731
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    out = on_cpu()
    first = out[0] if isinstance(out, tuple) else out
    assert first.device.type == "cpu"
    if fn.startswith("kernel_matrix"):
        assert torch.equal(call(device="cpu"), out)


def test_kernel_matrices_match_jax():
    rng = np.random.default_rng(3)
    y = rng.uniform(-0.2, 3.2, 40)
    ys = rng.uniform(0.02, 0.4, 40)
    grid = np.linspace(0, 3, 91)
    want, got = run_both(JK.kernel_matrix, TK.kernel_matrix, y, ys, grid,
                         torch_kw=dict(device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)

    jpd = JK.PDFDict(grid, np.linspace(0.01, 0.5, 30))
    tpd = pdfdict_from(jpd)
    np.testing.assert_array_equal(tpd.kernel_table, jpd.kernel_table)
    ji, je = (np.asarray(a) for a in jpd.fit(y, ys))
    ti, te = tpd.fit(y, ys)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(te, je)
    want = np.asarray(JK.kernel_matrix_dict(jpd, ji, je))
    got = TK.kernel_matrix_dict(tpd, ti, te, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("mode", ["rel", "cdf", "none"])
def test_threshold_weights_matches_jax(mode):
    rng = np.random.default_rng(4)
    w = rng.exponential(size=(6, 50)) ** 4
    w[0, :5] = w[0, 5]  # ties
    kw = {"rel": dict(wt_thresh=1e-3),
          "cdf": dict(wt_thresh=None, cdf_thresh=2e-2),
          "none": dict(wt_thresh=None, cdf_thresh=None)}[mode]
    want, got = run_both(JK.threshold_weights, TK.threshold_weights, w, **kw)
    np.testing.assert_array_equal(got, want)
    if mode == "cdf":
        # the reference quirk: the largest weight is always dropped
        assert np.all(got[np.arange(6), w.argmax(1)] == 0.0)


def _pdfs(n=9, ngrid=61, seed=5):
    rng = np.random.default_rng(seed)
    grid = np.linspace(0.0, 3.0, ngrid)
    mu = rng.uniform(0.2, 2.8, n)
    pdfs = np.exp(-0.5 * ((grid[None] - mu[:, None]) / 0.15) ** 2)
    pdfs += 0.05 * rng.uniform(size=pdfs.shape)
    return pdfs.astype(np.float32), grid


def _assert_cols_close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_pdfs_summarize_matches_jax_with_shared_uniforms():
    pdfs, grid = _pdfs()
    u = np.random.default_rng(0).random(len(pdfs)).astype(np.float32)
    kern_c = JS.loss_kernel_matrix(np.asarray(grid, np.float32))
    want = JS._summarize_core(pdfs, np.asarray(grid, np.float32), kern_c, u)
    got = TS.pdfs_summarize(torch.from_numpy(pdfs), grid, u=u)
    _assert_cols_close(to_numpy(TS._pack_summary(got)),
                       np.asarray(JS._pack_summary(want)))


def test_summary_stream_step_matches_jax():
    pdfs, grid = _pdfs(n=16)
    u_all = np.random.default_rng(1).random(40).astype(np.float32)
    g32 = np.asarray(grid, np.float32)
    kern = np.array(JS.loss_kernel_matrix(g32), np.float32)
    want = np.asarray(JS.summary_stream_step(pdfs, g32, kern, u_all, 8))
    got = TS.summary_stream_step(*(torch.from_numpy(x) for x in (
        pdfs, g32, kern, u_all)), 8).numpy()
    assert got.shape == (16, TS.SUMMARY_NCOLS)
    _assert_cols_close(got, want)


def test_interp_matches_numpy_edges_and_flats():
    xp = torch.tensor([0.0, 1.0, 1.0, 2.0, 4.0])
    fp = torch.tensor([0.0, 10.0, 20.0, 30.0, 50.0])
    x = torch.tensor([[-1.0, 0.0, 0.5, 1.0, 1.5, 3.0, 4.0, 9.0]])
    got = TS._interp(x, xp, fp).numpy()[0]
    want = np.interp(x.numpy()[0], xp.numpy(), fp.numpy())
    np.testing.assert_allclose(got, want)


def test_metrics_timer_and_progress():
    reg = Metrics()
    with reg.timer("phase", items=10, item_counter="pairs"):
        pass
    assert reg.counters["pairs"] == 10
    assert reg.timings["phase"]["n"] == 1
    assert reg.rate("pairs", "phase") > 0
    items = list(progress_iter([(0, 3), (3, 2)], total=5, sizes=True,
                               verbose=False))
    assert items == [(0, 3), (3, 2)]
