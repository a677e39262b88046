"""Port parity: `frankenz_tpu_torch.ops.fused_fit_pdf` and its kernels.

The port's two-pass full-mask route (``screen=False``: the two kernels'
plain versions on the CPU, glued as `_fused_call_fullmask_dimprior`
glues the Pallas pair) is held against the JAX route it replaces,
`fused_fit_pdf(screen=False, band_skip=False)` in interpret mode; the
port's default, the screened route, against JAX's default screened route
(and in depth in tests/test_torch_screened.py).  Tolerances are tests/test_fused.py:114-119's: lmap / levid rtol
2e-5, atol 2e-5 (float32 roundoff of the bracket -> lnl glue, and the
weight sum taken in another order); PDFs rtol 2e-3, atol 2e-5 (the same
weights stacked in another order; a weight sitting exactly on the
threshold may flip).
"""

import numpy as np
import pytest
import torch

from frankenz_tpu.ops.fused import fused_fit_pdf as jax_fused_fit_pdf

from _torch_port import fullmask_problem, run_both
from frankenz_tpu_torch.ops import fused as TF

GOF_TOL = dict(rtol=2e-5, atol=2e-5)
PDF_TOL = dict(rtol=2e-3, atol=2e-5)


def _jax(*args, **kw):
    return jax_fused_fit_pdf(*args, tb=8, tm=128, interpret=True, **kw)


def _assert_fused_close(want, got):
    pdf_w, lmap_w, levid_w = want
    pdf_g, lmap_g, levid_g = got
    assert pdf_g.shape == pdf_w.shape and pdf_g.dtype == np.float32
    np.testing.assert_allclose(lmap_g, lmap_w, **GOF_TOL)
    np.testing.assert_allclose(levid_g, levid_w, **GOF_TOL)
    np.testing.assert_allclose(pdf_g, pdf_w, **PDF_TOL)


@pytest.mark.parametrize("ignore_model_err", [False, True])
@pytest.mark.parametrize("wt_thresh", [1e-3, None])
@pytest.mark.parametrize("nfilt", [2, 5, 8, 20])
def test_fused_matches_jax_two_pass(nfilt, wt_thresh, ignore_model_err):
    """F=2 is a1 = 0 (no power), F=5/8 the sqrt chain, F=20 the log form;
    B=19, M=251, Ngrid=77 are ragged against every tile; row 0 is an
    all-clamped outlier, whose PDF is the fused route's uniform mixture
    on both sides."""
    prob = fullmask_problem(nfilt)
    kw = dict(wt_thresh=wt_thresh, ignore_model_err=ignore_model_err)
    want, got = run_both(_jax, TF.fused_fit_pdf, *prob, **kw,
                         jax_kw=dict(screen=False, band_skip=False),
                         torch_kw=dict(screen=False))
    _assert_fused_close(want, got)
    assert np.isfinite(got[0]).all()


@pytest.mark.parametrize("wt_thresh", [1e-3, None])
def test_fused_matches_jax_screened_default(wt_thresh):
    """JAX's default full-mask route is the screened trio, within f32
    reassociation of the two-pass pair; the port's default is the
    screened trio too, and matches it."""
    prob = fullmask_problem(5, outlier_row=False)
    want, got = run_both(_jax, TF.fused_fit_pdf, *prob, wt_thresh=wt_thresh)
    _assert_fused_close(want, got)


def test_all_clamped_rows_keep_gof_parity():
    """tests/test_fused.py::test_fullmask_all_clamped_outliers_keep_gof_
    parity, through the port: every chi^2 is past the clamp, lmap and
    levid still match JAX at float32 and the PDF is finite."""
    rng = np.random.default_rng(1)
    B, M, F, Ng = 8, 3, 3, 33
    m = rng.uniform(1, 2, (M, F)).astype(np.float32)
    d = np.full((B, F), 1e6, np.float32)
    de = np.full((B, F), 1.0, np.float32)
    G = np.abs(rng.normal(size=(M, Ng))).astype(np.float32)
    G /= G.sum(1, keepdims=True)
    args = (d, de, np.ones_like(d), m, np.zeros_like(m), np.ones_like(m), G)
    want, got = run_both(_jax, TF.fused_fit_pdf, *args, full_mask=True,
                         ignore_model_err=True,
                         jax_kw=dict(screen=False, band_skip=False),
                         torch_kw=dict(screen=False))
    np.testing.assert_allclose(got[1], want[1], rtol=1e-7)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-7)
    np.testing.assert_allclose(got[0], want[0], **PDF_TOL)
    assert np.isfinite(got[0]).all()


def test_route_decisions():
    """(e) The routing rule, decided without launching anything: every
    configuration has a kernel route, the same on every device.  Full
    masks take the screened trio (K2) by default, as in JAX, and the K1
    pair with ``screen=False``."""
    route = TF.fused_route
    assert route(full_mask=True) == "screened"
    assert route(full_mask=True, wt_thresh=None) == "screened"
    assert route(full_mask=True, screen=False) == "fullmask"
    assert route(full_mask=True, wt_thresh=None, screen=False) == "fullmask"
    # K3 and K5 configurations run the general kernels, free scale (K6)
    # too.
    for kw in (dict(full_mask=False), dict(full_mask=True, dim_prior=False),
               dict(full_mask=False, wt_thresh=None, cdf_thresh=2e-4),
               dict(full_mask=True, wt_thresh=None, cdf_thresh=2e-4),
               dict(full_mask=True, free_scale=True),
               dict(full_mask=False, free_scale=True, wt_thresh=None,
                    cdf_thresh=2e-4)):
        assert route(**kw) == "general"
    # Both thresholds None off the K1 pair: the one-pass kernel (K4).
    for kw in (dict(full_mask=False, wt_thresh=None),
               dict(full_mask=True, dim_prior=False, wt_thresh=None),
               dict(full_mask=True, free_scale=True, wt_thresh=None)):
        assert route(**kw) == "onepass"


def test_cpu_masked_and_free_scale_configurations(monkeypatch):
    """Masked data takes the general route, whose kernels' plain versions
    run on the CPU; free scale takes it too, through the same glue, and
    the plain likelihood computes it as well."""
    from frankenz_tpu_torch.kernels import general as GK
    from frankenz_tpu_torch.ops import likelihood as TL

    calls = []
    for name in ("lnl_reduce_plain", "lnl_stack_plain",
                 "lnl_stack_band_plain"):
        orig = getattr(GK, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append((_name, k.get("free_scale")))
            return _orig(*a, **k)

        monkeypatch.setattr(GK, name, spy)
    prob = list(fullmask_problem(5, outlier_row=False))
    prob[2] = prob[2].copy()
    prob[2][:, 1] = 0.0
    want, got = run_both(_jax, TF.fused_fit_pdf, *prob,
                         jax_kw=dict(screen=False, band_skip=False))
    _assert_fused_close(want, got)
    # Fixed scale reads its table in band order (`lnl_stack_band`).
    assert calls == [("lnl_reduce_plain", False),
                     ("lnl_stack_band_plain", None)]
    out = TF.fused_fit_pdf(*prob, free_scale=True)
    assert calls[2:] == [("lnl_reduce_plain", True),
                         ("lnl_stack_plain", True)]
    assert all(np.isfinite(x.numpy()[1:]).all() for x in out)
    assert TL.logprob(*(torch.from_numpy(x) for x in prob[:6]),
                      free_scale=True).lnprob.shape == (19, 251)


@pytest.mark.parametrize("route", [
    dict(screen=False),
    dict(masked=True),
    dict(masked=True, wt_thresh=None, cdf_thresh=None),
    dict(masked=True, wt_thresh=None, cdf_thresh=2e-4, cdf_exact=True),
    dict(masked=True, free_scale=True, ignore_model_err=True)],
    ids=["fullmask", "table", "onepass", "cdf", "free_table"])
def test_band_argument_matches_the_sort_in_the_call(route, monkeypatch):
    """``band=model_bands(...)`` (what the fitters sort once a device)
    gives the results of the sort made in the call bit for bit, and the
    call then sorts nothing."""
    from frankenz_tpu_torch.kernels import general as GK

    kw = dict(route)
    prob = [torch.from_numpy(x) for x in fullmask_problem(
        5, outlier_row=False)]
    if kw.pop("masked", False):
        prob[2] = prob[2].clone()
        prob[2][::3, 1] = 0.0
        kw["full_mask"] = False
    want = TF.fused_fit_pdf(*prob, **kw)
    band = TF.model_bands(*prob[3:])
    sorts = []
    monkeypatch.setattr(TF, "band_sort",
                        lambda *a, **k: sorts.append(1) or GK.band_sort(
                            *a, **k))
    got = TF.fused_fit_pdf(*prob, band=band, **kw)
    assert not sorts
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
