"""Port parity for `plotting`: the six diagnostics with ``plot=False``
against the JAX package's on the same inputs and seeds, one render on
the Agg backend, and the module without matplotlib.

The inputs are tests/test_plotting.py's (200 Gaussian PDFs on a 151-point
grid, a 40-sigma PDFDict; a 4 x 4 SOM over 300 models, trained in JAX and
carried across with `network_from_jax`).  Both packages prepare in
float64 (the JAX suite runs with x64) and draw the same NumPy `Generator`
numbers, so the stacks, coverage curves and node values agree to float64
roundoff: rtol 1e-10, atol 1e-12.
"""

import importlib
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import _torch_port  # noqa: F401,E402  (one torch thread per test worker)
import frankenz_tpu_torch  # noqa: E402
from frankenz_tpu import plotting as JP  # noqa: E402
from frankenz_tpu.models import SelfOrganizingMap as JaxSOM  # noqa: E402
from frankenz_tpu.ops import PDFDict as JaxPDFDict  # noqa: E402
from frankenz_tpu_torch import plotting as TP  # noqa: E402
from frankenz_tpu_torch.ops import PDFDict  # noqa: E402
from frankenz_tpu_torch.utils import network_from_jax  # noqa: E402

TOL = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(8)
    nobj, ngrid = 200, 151
    grid = np.linspace(0, 3, ngrid)
    ztrue = rng.uniform(0.2, 2.8, nobj)
    zerr = np.full(nobj, 0.1)
    sig = 0.15
    pdfs = np.exp(-0.5 * ((grid[None, :] - ztrue[:, None]) / sig) ** 2)
    pdfs /= pdfs.sum(axis=1, keepdims=True)
    sgrid = np.linspace(0.02, 0.3, 40)
    return dict(z=ztrue, zerr=zerr, pdfs=pdfs, grid=grid, sig=sig,
                jdict=JaxPDFDict(grid, sgrid), tdict=PDFDict(grid, sgrid),
                weights=rng.uniform(0.0, 1.0, nobj))


STACK_CASES = {
    "defaults": {},
    "pdf_cdf_cut": dict(pdf_wt_thresh=None, pdf_cdf_thresh=2e-2),
    "no_pdf_cut": dict(pdf_wt_thresh=None, pdf_cdf_thresh=None),
    "outer_cdf_cut": dict(wt_thresh=None, cdf_thresh=0.05, weights="w"),
    "outer_wt_cut": dict(wt_thresh=0.3, weights="w", smooth=1.5),
    "no_outer_cut": dict(wt_thresh=None, cdf_thresh=None, weights="w"),
}


def _case(setup, case):
    kw = dict(STACK_CASES[case])
    if kw.get("weights") == "w":
        kw["weights"] = setup["weights"]
    return kw


@pytest.mark.parametrize("case", sorted(STACK_CASES))
def test_input_vs_pdf_matches_jax(setup, case):
    s, kw = setup, _case(setup, case)
    want = JP.input_vs_pdf(s["z"], s["zerr"], s["jdict"], s["pdfs"],
                           s["grid"], plot=False, **kw)
    got = TP.input_vs_pdf(s["z"], s["zerr"], s["tdict"], s["pdfs"],
                          s["grid"], plot=False, **kw)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # CPU tensors in: the same stack.
    again = TP.input_vs_pdf(torch.tensor(s["z"]), torch.tensor(s["zerr"]),
                            s["tdict"], torch.tensor(s["pdfs"]),
                            s["grid"], plot=False, **kw)
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("case", ["defaults", "pdf_cdf_cut",
                                  "outer_cdf_cut"])
def test_input_vs_dpdf_matches_jax(setup, case):
    s, kw = setup, _case(setup, case)
    dgrid = np.linspace(-1, 1, 101)
    # Centres off the truths, so the recentred rows are interpolated.
    cent = s["z"] + 0.013
    want = JP.input_vs_dpdf(s["z"], s["zerr"], s["jdict"], s["pdfs"],
                            s["grid"], cent, dgrid, plot=False, **kw)
    got = TP.input_vs_dpdf(s["z"], s["zerr"], s["tdict"], s["pdfs"],
                           s["grid"], cent, dgrid, plot=False, **kw)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_input_vs_dpdf_custom_dispersion(setup):
    """A fractional dispersion (pgrid - cent) / (1 + cent): the port calls
    `disp_func` once on broadcastable tensors, JAX once a row."""
    s = setup
    dgrid = np.linspace(-0.5, 0.5, 81)

    def frac(pg, cent, scale):
        return scale * (pg - cent) / (1.0 + cent)

    kw = dict(disp_func=frac, disp_args=(1.0,), plot=False)
    want = JP.input_vs_dpdf(s["z"], s["zerr"], s["jdict"], s["pdfs"],
                            s["grid"], s["z"], dgrid, **kw)
    got = TP.input_vs_dpdf(s["z"], s["zerr"], s["tdict"], s["pdfs"],
                           s["grid"], s["z"], dgrid, **kw)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_coverage_tests_match_jax(setup, weighted):
    s = setup
    sig = np.full_like(s["z"], s["sig"])
    w = s["weights"] if weighted else None
    kw = dict(Nmc=50, weights=w, seed=3, plot=False)
    want = JP.cdf_vs_epdf(s["z"], sig, s["pdfs"], s["grid"], **kw)
    got = TP.cdf_vs_epdf(s["z"], sig, s["pdfs"], s["grid"], **kw)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    want = JP.cdf_vs_ecdf(s["z"], sig, s["pdfs"], s["grid"], **kw)
    got = TP.cdf_vs_ecdf(s["z"], sig, s["pdfs"], s["grid"], **kw)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(x), **TOL)
    # The draws themselves, from one generator state each.
    a = JP._cdf_draws(s["z"], sig, s["pdfs"], s["grid"], 7,
                      np.random.default_rng(1))
    b = TP._cdf_draws(s["z"], sig, s["pdfs"], s["grid"], 7,
                      np.random.default_rng(1))
    np.testing.assert_allclose(b, np.asarray(a), **TOL)


@pytest.fixture(scope="module")
def network():
    rng = np.random.default_rng(5)
    models = rng.uniform(1, 10, (300, 4))
    som = JaxSOM(models, 0.05 * models, np.ones_like(models))
    som.train_network(nside=4, nproj=2, niter=50, nbatch=20, seed=1,
                      verbose=False)
    som.populate_network(verbose=False)
    return som, network_from_jax(som, device="cpu"), models


@pytest.mark.parametrize("kw", [
    dict(counts="absolute"), dict(counts="weighted"),
    dict(labels="band0", point_est="mean"),
    dict(labels="band0", point_est="median", labels_err=0.1, seed=2),
    dict(labels="band0", point_est="mad", discrete=True),
    dict(labels="band0", point_est="std"),
], ids=["absolute", "weighted", "mean", "median_mc", "mad_discrete", "std"])
def test_plot2d_network_matches_jax(network, kw):
    som, port, models = network
    kw = dict(kw)
    if kw.get("labels") == "band0":
        kw["labels"] = models[:, 0]
    if "labels_err" in kw:
        kw["labels_err"] = np.full(len(models), kw["labels_err"])
    want = JP.plot2d_network(som, plot=False, **kw)
    got = TP.plot2d_network(port, plot=False, **kw)
    np.testing.assert_allclose(got, np.asarray(want), equal_nan=True, **TOL)


def test_plot_node_matches_jax(network):
    som, port, models = network
    idx = int(np.argmax(som.nodes_Nmatch))
    kw = dict(idx=idx, seed=4, Nrsamp=2, plot=False)
    want = JP.plot_node(som, models, 0.05 * models, **kw)
    got = TP.plot_node(port, models, 0.05 * models, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_rendering_smoke(setup, network):
    """One end-to-end render of each diagram on the Agg backend."""
    import matplotlib.pyplot as plt

    s = setup
    som, port, models = network
    sig = np.full(50, s["sig"])
    for draw in (
            lambda: TP.input_vs_pdf(s["z"][:50], s["zerr"][:50], s["tdict"],
                                    s["pdfs"][:50], s["grid"]),
            lambda: TP.input_vs_dpdf(s["z"][:50], s["zerr"][:50],
                                     s["tdict"], s["pdfs"][:50], s["grid"],
                                     s["z"][:50], np.linspace(-1, 1, 41)),
            lambda: TP.cdf_vs_epdf(s["z"][:50], sig, s["pdfs"][:50],
                                   s["grid"], Nmc=20, seed=0),
            lambda: TP.cdf_vs_ecdf(s["z"][:50], sig, s["pdfs"][:50],
                                   s["grid"], Nmc=20, seed=0),
            lambda: TP.plot2d_network(port),
            lambda: TP.plot_node(port, models, 0.05 * models, idx=0,
                                 seed=1)):
        fig = plt.figure()
        draw()
        assert fig.axes
        plt.close("all")


def test_no_matplotlib(monkeypatch, setup, network):
    """The card's machine has no matplotlib: the module imports and every
    ``plot=False`` call runs without it; ``plot=True`` needs it."""
    s = setup
    som, port, models = network
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "frankenz_tpu_torch.plotting")
    monkeypatch.setattr(frankenz_tpu_torch, "plotting", TP)
    fresh = importlib.import_module("frankenz_tpu_torch.plotting")
    assert fresh is not TP
    sig = np.full_like(s["z"], s["sig"])
    fresh.input_vs_pdf(s["z"], s["zerr"], s["tdict"], s["pdfs"], s["grid"],
                       plot=False)
    fresh.input_vs_dpdf(s["z"], s["zerr"], s["tdict"], s["pdfs"], s["grid"],
                        s["z"], np.linspace(-1, 1, 21), plot=False)
    fresh.cdf_vs_epdf(s["z"], sig, s["pdfs"], s["grid"], Nmc=5, seed=0,
                      plot=False)
    fresh.cdf_vs_ecdf(s["z"], sig, s["pdfs"], s["grid"], Nmc=5, seed=0,
                      plot=False)
    fresh.plot2d_network(port, plot=False)
    fresh.plot_node(port, models, 0.05 * models, idx=0, seed=1, plot=False)
    with pytest.raises(ImportError):
        fresh.cdf_vs_epdf(s["z"], sig, s["pdfs"], s["grid"], Nmc=5, seed=0)
