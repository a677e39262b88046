"""The PyTorch port's demos (demos/torch_demo*.py) as end-to-end tests on
the CPU, at tests/test_demos.py's sizes and with its assertions.  A demo
imports no JAX; here each runs with ``device="cpu"``.

Demos 2-4 are also held against the JAX demos (demos/demo2-4) run on the
same mock catalog.  The port's BruteForce takes its fused route on every
device, where the JAX fitter on the CPU takes its XLA route; the JAX
demos run here with the JAX fitter on its fused route too (an eligible
call's ``use_fused=None`` passed as True), so both sides take the same
route.  Tolerances: PDFs rtol 2e-3 / atol 2e-5 (tests/test_fused.py);
summaries rtol 2e-3 / atol 2e-4 (tests/test_fit_summarize.py across
routes), the least-loss point within one grid step (an argmin over the
grid, whose near-ties flip under those PDF differences) and the MC
draws not compared (each package draws its own); the SOM trains on each
side (nodes agree at 2e-4, tests/test_torch_networks.py), so its PDFs
are held by row L1 distance, at most 1e-2 (the demo's own SOM-against-
BruteForce L1 is about 3e-2).
"""

import os
import sys
import warnings

import numpy as np
import pytest

import _torch_port  # noqa: F401  (one torch thread per test worker)

PDF_TOL = dict(rtol=2e-3, atol=2e-5)
SUMMARY_TOL = dict(rtol=2e-3, atol=2e-4)
NFIT2, NFIT3, NFIT4 = 150, 200, 100

DEMOS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "demos")
sys.path.insert(0, DEMOS)


@pytest.fixture(scope="module")
def outdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_demo_output"))


@pytest.fixture(scope="module")
def demo1(outdir):
    import torch_demo1_mock_data

    data, survey = torch_demo1_mock_data.main(nobj=400, out=outdir,
                                              plot=False, nz=100,
                                              device="cpu")
    return outdir, data, survey


def test_demo1(demo1):
    outdir, data, survey = demo1
    mock = np.load(os.path.join(outdir, "mock_sdss_cww_bpz.npz"))
    assert mock["models"].shape == (100 * 8, 5)
    assert np.isfinite(mock["models"]).all()


@pytest.fixture(scope="module")
def port_demos(demo1):
    import torch_demo2_photometric_inference
    import torch_demo3_photometric_pdfs
    import torch_demo4_posterior_approximations

    out = demo1[0]
    return dict(
        d2=torch_demo2_photometric_inference.main(
            out=out, nfit=NFIT2, plot=False, device="cpu"),
        d3=torch_demo3_photometric_pdfs.main(
            out=out, nfit=NFIT3, plot=False, device="cpu"),
        d4=torch_demo4_posterior_approximations.main(
            out=out, nfit=NFIT4, plot=False, device="cpu"))


@pytest.fixture(scope="module")
def jax_demos(demo1):
    """JAX's demos 2-4 on the port's mock, the JAX fitter on its fused
    route wherever the call is eligible."""
    import demo2_photometric_inference
    import demo3_photometric_pdfs
    import demo4_posterior_approximations
    from frankenz_tpu.fitting import BruteForce

    fit_predict = BruteForce.fit_predict

    def fused_fit_predict(self, *args, use_fused=None, lprob_func=None,
                          **kw):
        if use_fused is None and lprob_func is None:
            use_fused = True
        return fit_predict(self, *args, use_fused=use_fused,
                           lprob_func=lprob_func, **kw)

    out = demo1[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BruteForce, "fit_predict", fused_fit_predict)
        return dict(
            d2=demo2_photometric_inference.main(out=out, nfit=NFIT2,
                                                plot=False),
            d3=demo3_photometric_pdfs.main(out=out, nfit=NFIT3, plot=False),
            d4=demo4_posterior_approximations.main(out=out, nfit=NFIT4,
                                                   plot=False))


def test_demo2(port_demos):
    results = port_demos["d2"]
    assert set(results) == {"mag", "color", "color+bpz"}
    for pdfs in results.values():
        assert pdfs.shape == (NFIT2, 701)
        np.testing.assert_allclose(pdfs.sum(axis=1), 1.0, atol=1e-3)


def test_demo3(port_demos):
    pdfs, s = port_demos["d3"]
    assert pdfs.shape[0] == NFIT3
    assert np.isfinite(s.median.point.numpy()).all()


def test_demo4(port_demos):
    results = port_demos["d4"]
    assert set(results) == {"bruteforce", "kmcknn", "som nodes"}


def test_demo2_matches_jax(port_demos, jax_demos):
    got, want = port_demos["d2"], jax_demos["d2"]
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   **PDF_TOL, err_msg=name)


def test_demo3_matches_jax(port_demos, jax_demos):
    (pdfs, s), (pdfs_w, s_w) = port_demos["d3"], jax_demos["d3"]
    np.testing.assert_allclose(pdfs, np.asarray(pdfs_w), **PDF_TOL)
    for name in ("mean", "median", "mode", "best"):
        got, want = getattr(s, name), getattr(s_w, name)
        fields = ("point", "std", "conf", "risk") if name != "best" \
            else ("risk",)
        for f in fields:
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       **SUMMARY_TOL, err_msg=f"{name}.{f}")
    dbest = np.abs(s.best.point.numpy() - np.asarray(s_w.best.point))
    assert np.all(dbest <= 7.0 / 700 + SUMMARY_TOL["atol"])
    for name in ("low95", "low68", "high68", "high95"):
        np.testing.assert_allclose(getattr(s, name).numpy(),
                                   np.asarray(getattr(s_w, name)),
                                   **SUMMARY_TOL, err_msg=name)


def test_demo4_matches_jax(port_demos, jax_demos):
    got, want = port_demos["d4"], jax_demos["d4"]
    assert set(got) == set(want)
    for name in ("bruteforce", "kmcknn"):
        np.testing.assert_allclose(got[name][0], np.asarray(want[name][0]),
                                   **PDF_TOL, err_msg=name)
    l1 = np.abs(got["som nodes"][0]
                - np.asarray(want["som nodes"][0])).sum(axis=1)
    assert l1.max() <= 1e-2, l1.max()


def test_demo5(tmp_path):
    import torch_demo5_population_inference

    s = torch_demo5_population_inference.main(
        out=str(tmp_path), nobs=200, niter=10, thin=50, nchains=1,
        plot=False, device="cpu")
    samples, lnps = s.results
    assert samples.shape == (10, 60)


def test_demo6(tmp_path):
    import torch_demo6_hierarchical_inference

    with warnings.catch_warnings():
        # The reference-comparison arm must compare: an empty burn-in
        # slice would warn (mean of empty slice).
        warnings.simplefilter("error", RuntimeWarning)
        s = torch_demo6_hierarchical_inference.main(
            out=str(tmp_path), nobs=200, niter=20, plot=False, device="cpu")
    samples, _ = s.results
    assert len(samples) == 40  # 2 chains interleaved


def test_demos_import_no_jax(tmp_path):
    """In a fresh interpreter where `import jax` fails, every port demo
    imports and demo 5 runs."""
    import subprocess

    fake = tmp_path / "jax"
    fake.mkdir()
    (fake / "__init__.py").write_text(
        "raise ImportError('the PyTorch port must not import jax')\n")
    code = ("import torch_demo1_mock_data, torch_demo2_photometric_inference,"
            " torch_demo3_photometric_pdfs, "
            "torch_demo4_posterior_approximations, "
            "torch_demo5_population_inference as d5, "
            "torch_demo6_hierarchical_inference\n"
            f"d5.main(out={str(tmp_path)!r}, nobs=50, niter=2, thin=5, "
            "nchains=1, plot=False, device='cpu')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), DEMOS, os.path.dirname(DEMOS)]))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
