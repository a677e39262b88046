"""Port parity for the slice: BruteForce.fit_predict and fit_summarize.

The JAX fitter is built from NumPy inputs, carried across with
`from_jax_bruteforce`, and both fit the same catalog (B=300, M=2000,
F=5, Ngrid=101).  The port's default route on the CPU is the full-mask
kernels' plain versions; it is held against JAX's `use_fused=True`
(the screened Pallas route, interpret mode) and `use_fused=False` (XLA),
at tests/test_fused.py's tolerances: lmap / levid 2e-5, PDFs rtol 2e-3
atol 2e-5.  Summaries follow tests/test_fit_summarize.py: rtol 2e-3 /
atol 2e-4 across routes (PDF differences move quantiles), and exact-
route comparisons at 2e-5 / 2e-6.
"""

import numpy as np
import pytest
import torch

from _torch_port import to_numpy
from frankenz_tpu.models import BruteForce as JaxBruteForce
from frankenz_tpu.ops import summarize as JS
from frankenz_tpu_torch.ops import pdfs_summarize
from frankenz_tpu_torch.ops import summarize as TS
from frankenz_tpu_torch.utils import from_jax_bruteforce

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
    p = slice_problem
    bf = p["torch"]
    with pytest.raises(NotImplementedError, match="mesh"):
        bf.fit_predict(*p["args"], mesh=object(), **p["kw"])
    with pytest.raises(NotImplementedError, match="resume"):
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
