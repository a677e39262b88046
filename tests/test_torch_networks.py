"""Port parity for the SelfOrganizingMap path: training, populate, node
PDFs, fit / predict / fit_predict / fit_summarize.

The same NumPy inputs go through `frankenz_tpu`'s SelfOrganizingMap (on
the CPU, x64, the SOM Pallas kernel in interpret mode) and the port's
(on CPU tensors: the `som_train` kernel's plain version).  Populate and
the fits run on one JAX-trained map carried across with
`network_from_jax`, so they are held against JAX independently of
training.  Tolerances: trained nodes rtol / atol 2e-4 (JAX's own
`test_som_pallas_mega_kernel_matches_scan`); member tables equal and
log-weights rtol 1e-5; PDFs rtol 2e-3 / atol 2e-5 and lmap / levid
rtol 1e-5; summaries rtol 2e-3 / atol 2e-4 (tests/test_fit_summarize.py).
"""

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from frankenz_tpu.models import SelfOrganizingMap as JaxSOM
from frankenz_tpu.ops import PDFDict as JaxPDFDict
from frankenz_tpu_torch.models import SelfOrganizingMap
from frankenz_tpu_torch.models import networks as TN
from frankenz_tpu_torch.utils import network_from_jax, pdfdict_from

NODE_TOL = dict(rtol=2e-4, atol=2e-4)
PDF_TOL = dict(rtol=2e-3, atol=2e-5)
GOF_TOL = dict(rtol=1e-5, atol=1e-6)
TABLES = ("nodes_idxs", "nodes_Nmatch", "nodes_bmus", "nodes_Nbmu")


@pytest.fixture(scope="module")
def blob_problem():
    """tests/test_networks.py's blobs: 4 clusters in 3-band flux space,
    a redshift label tied to the cluster."""
    rng = np.random.default_rng(42)
    centers = np.array([[2.0, 5.0, 8.0], [8.0, 3.0, 2.0],
                        [5.0, 9.0, 4.0], [9.0, 8.0, 7.0]])
    zc = np.array([0.3, 1.0, 1.8, 2.6])
    models = np.vstack([c + rng.normal(0, 0.3, (100, 3)) for c in centers])
    zlab = np.concatenate([z + rng.normal(0, 0.05, 100) for z in zc])
    return models, np.full_like(models, 0.05), np.ones_like(models), zlab


@pytest.fixture(scope="module")
def masked_problem():
    """tests/test_networks.py:403-421: zero-error and masked bands."""
    rng = np.random.default_rng(8)
    centers = rng.uniform(2, 9, (4, 5))
    models = np.vstack([c + rng.normal(0, 0.3, (80, 5)) for c in centers])
    me = np.full_like(models, 0.05)
    mm = np.ones_like(models)
    me[::7, 0] = 0.0
    mm[1::5, 2] = 0.0
    return models, me, mm


def _both(problem, jax_kw, torch_kw, **kw):
    a = JaxSOM(*problem[:3])
    a.train_network(**jax_kw, **kw)
    b = SelfOrganizingMap(*problem[:3], device="cpu")
    b.train_network(**torch_kw, **kw)
    return a, b


def _assert_nodes_close(got, want):
    err = np.abs(got - want)
    worst = float((err / (NODE_TOL["atol"]
                          + NODE_TOL["rtol"] * np.abs(want))).max())
    np.testing.assert_allclose(got, want, **NODE_TOL,
                               err_msg=f"max abs {err.max():.3g}, worst "
                                       f"{worst:.3g} x tol")


BLOB_KW = dict(nside=4, nproj=2, niter=40, nbatch=10, seed=9, verbose=False)
MASKED_KW = dict(nside=3, nproj=2, niter=30, nbatch=10, seed=2,
                 verbose=False)


@pytest.mark.parametrize("which", ["blob", "masked"])
def test_kernel_route_matches_the_pallas_kernel(blob_problem, masked_problem,
                                                which):
    """The plain version of `som_train` against JAX's mega-kernel
    (interpret mode) from the same numpy draws."""
    problem, kw = ((blob_problem, BLOB_KW) if which == "blob"
                   else (masked_problem, MASKED_KW))
    a, b = _both(problem, dict(use_pallas=True), dict(use_kernel=True), **kw)
    assert b.nodes.shape == a.nodes.shape and b.nodes.dtype == np.float64
    _assert_nodes_close(b.nodes, a.nodes)
    np.testing.assert_array_equal(b.nodes_pos, a.nodes_pos)
    assert (b.NNODE, b.NPROJ, b.NSIDE) == (a.NNODE, a.NPROJ, a.NSIDE)
    # On CPU tensors the default route is the kernel route.
    c = SelfOrganizingMap(*problem[:3], device="cpu")
    c.train_network(**kw)
    np.testing.assert_array_equal(c.nodes, b.nodes)


@pytest.mark.parametrize("extra", [
    dict(),
    dict(track_scale=True),
    dict(wt_thresh=None, cdf_thresh=2e-4),
    dict(neighbor_func="lorentz", learn_func="geometric"),
])
def test_general_route_matches_the_scan(blob_problem, extra):
    """`use_kernel=False` against JAX's `use_pallas=False` scan."""
    import frankenz_tpu.models.networks as JN

    jx, tx = dict(extra), dict(extra)
    for key, mod_j, mod_t in (("neighbor_func", JN, TN),
                              ("learn_func", JN, TN)):
        if key in extra:
            name = ("neighbor_" if key == "neighbor_func" else "learn_") \
                + extra[key]
            jx[key], tx[key] = getattr(mod_j, name), getattr(mod_t, name)
    a, b = _both(blob_problem, dict(use_pallas=False, **jx),
                 dict(use_kernel=False, **tx), **BLOB_KW)
    _assert_nodes_close(b.nodes, a.nodes)


def test_use_kernel_true_refuses_an_ineligible_configuration(blob_problem):
    som = SelfOrganizingMap(*blob_problem[:3], device="cpu")
    with pytest.raises(ValueError, match="use_kernel"):
        som.train_network(use_kernel=True, track_scale=True, **BLOB_KW)
    with pytest.raises(ValueError, match="use_kernel"):
        som.train_network(use_kernel=True, wt_thresh=None, **BLOB_KW)
    # Checkpoints are ported: a plan without a file fails fast.
    with pytest.raises(ValueError, match="checkpoint_file"):
        som.train_network(checkpoint_every=5, **BLOB_KW)


def test_lattice_cap_is_the_kernels_own():
    """32,768 nodes (nside 181 at nproj 2 is 32,761) take the kernel at
    any admitted filter count; nside 182 (33,124 nodes) is refused with
    use_kernel=True and takes the general route by default."""
    rng = np.random.default_rng(0)
    m = rng.uniform(1, 10, (40000, 3)).astype(np.float32)
    som = SelfOrganizingMap(m, 0.05 * m, np.ones_like(m), device="cpu")
    with pytest.raises(ValueError, match="32768 nodes"):
        som.train_network(nside=182, nproj=2, niter=1, nbatch=1, seed=0,
                          use_kernel=True, verbose=False)
    som.train_network(nside=182, nproj=2, niter=1, nbatch=1, seed=0,
                      verbose=False)
    assert som.nodes.shape == (182 * 182, 3)
    som.train_network(nside=181, nproj=2, niter=1, nbatch=1, seed=0,
                      use_kernel=True, verbose=False)
    assert som.nodes.shape == (181 * 181, 3)
    m80 = rng.uniform(1, 10, (7000, 80)).astype(np.float32)
    wide = SelfOrganizingMap(m80, 0.05 * m80, np.ones_like(m80),
                             device="cpu")
    wide.train_network(nside=78, nproj=2, niter=1, nbatch=1, seed=0,
                       use_kernel=True, verbose=False)
    assert wide.nodes.shape == (78 * 78, 80)


def test_cuda_device_raises_without_a_card(blob_problem):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SelfOrganizingMap(*blob_problem[:3], device="cuda")


@pytest.fixture(scope="module")
def trained(blob_problem):
    """One JAX map (the scan, 2,000 steps), populated at the default
    threshold, and its port twin carried across before populate."""
    som = JaxSOM(*blob_problem[:3])
    som.train_network(nside=4, nproj=2, niter=100, nbatch=20, seed=3,
                      verbose=False)
    port = network_from_jax(som, device="cpu")
    som.populate_network(verbose=False)
    port.populate_network(verbose=False)
    return som, port


def _assert_tables_equal(got, want):
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    fin = np.isfinite(want.nodes_logwts)
    np.testing.assert_array_equal(np.isfinite(got.nodes_logwts), fin)
    np.testing.assert_allclose(got.nodes_logwts[fin], want.nodes_logwts[fin],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.nodes_scales, want.nodes_scales,
                               rtol=1e-5)
    np.testing.assert_allclose(got.nodes_scales_err, want.nodes_scales_err,
                               rtol=1e-5)
    np.testing.assert_allclose(got.models_lmap, want.models_lmap, **GOF_TOL)
    np.testing.assert_allclose(got.models_levid, want.models_levid,
                               **GOF_TOL)


def test_populate_member_tables_equal_jax(trained):
    som, port = trained
    assert port.nodes_Nbmu.sum() == port.NMODEL
    _assert_tables_equal(port, som)


def test_populate_two_phase_cap_and_its_error(blob_problem):
    """Wide errors make each model match more than the 16-slot phase-1
    slab: the escalated second phase gives JAX's tables, and a cap below
    a model's matches raises."""
    models, _, mm, _ = blob_problem
    wide = (models, np.full_like(models, 5.0), mm)
    som = JaxSOM(*wide)
    som.train_network(nside=5, nproj=2, niter=100, nbatch=20, seed=3,
                      verbose=False)
    port = network_from_jax(som, device="cpu")
    som.populate_network(wt_thresh=1e-6, verbose=False)
    port.populate_network(wt_thresh=1e-6, verbose=False)
    assert port.nodes_Nmatch.sum() > port.NMODEL * TN._POPULATE_PHASE1_CAP
    _assert_tables_equal(port, som)
    with pytest.raises(ValueError, match="max_nodes_per_model"):
        port.populate_network(wt_thresh=1e-6, max_nodes_per_model=20,
                              verbose=False)


def test_network_from_jax_carries_the_populated_state(trained):
    som, _ = trained
    port = network_from_jax(som, device="cpu")
    _assert_tables_equal(port, som)
    assert port.lpnet_kwargs == som.lpnet_kwargs
    np.testing.assert_array_equal(port.nodes, som.nodes)


@pytest.fixture(scope="module")
def labels(blob_problem):
    zlab = blob_problem[3]
    grid = np.linspace(0, 3, 151)
    pd = JaxPDFDict(grid, np.linspace(0.01, 0.3, 30))
    return dict(zlab=zlab, zerr=np.full_like(zlab, 0.05), grid=grid,
                jax={"grid": dict(label_grid=grid),
                     "dict": dict(label_dict=pd)},
                port={"grid": dict(label_grid=grid),
                      "dict": dict(label_dict=pdfdict_from(pd))})


@pytest.mark.parametrize("discrete", [False, True])
@pytest.mark.parametrize("lab", ["grid", "dict"])
def test_get_pdfs_match_jax(trained, labels, lab, discrete):
    som, port = trained
    args = (labels["zlab"], labels["zerr"])
    want = som.get_pdfs(*args, return_gof=True, discrete=discrete,
                        verbose=False, **labels["jax"][lab])
    got = port.get_pdfs(*args, return_gof=True, discrete=discrete,
                        verbose=False, batch_size=5, **labels["port"][lab])
    np.testing.assert_allclose(got[0], want[0], **PDF_TOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], **GOF_TOL)
    one = port.get_pdf(3, *args, discrete=discrete, **labels["port"][lab])
    np.testing.assert_array_equal(one, got[0][3])


def test_get_node_matches_jax(trained):
    som, port = trained
    for kw in (dict(idx=2), dict(pos=(1.2, 2.9)), dict(idx=5, discrete=True)):
        for g, w in zip(port.get_node(**kw), som.get_node(**kw)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture(scope="module")
def catalog(blob_problem):
    rng = np.random.default_rng(5)
    models = blob_problem[0]
    truth = rng.integers(0, len(models), 40)
    data = models[truth] + rng.normal(0, 0.1, (40, 3))
    return data, np.full_like(data, 0.1), np.ones_like(data)


def _assert_fp_close(got, want):
    np.testing.assert_allclose(got[0], want[0], **PDF_TOL)
    np.testing.assert_allclose(got[1][0], want[1][0], **GOF_TOL)
    np.testing.assert_allclose(got[1][1], want[1][1], **GOF_TOL)


@pytest.mark.parametrize("save_fits", [True, False])
@pytest.mark.parametrize("nodes_only", [True, False])
@pytest.mark.parametrize("lab", ["grid", "dict"])
def test_fit_predict_matches_jax(trained, labels, catalog, lab, nodes_only,
                                 save_fits):
    som, port = trained
    kw = dict(nodes_only=nodes_only, verbose=False, batch_size=16,
              max_neighbors=512, return_gof=True, save_fits=save_fits)
    args = catalog + (labels["zlab"], labels["zerr"])
    want = som.fit_predict(*args, **kw, **labels["jax"][lab])
    got = port.fit_predict(*args, **kw, **labels["port"][lab])
    _assert_fp_close(got, want)
    np.testing.assert_allclose(got[0].sum(axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("nodes_only", [True, False])
def test_fit_stores_jax_grids_and_predict_matches(trained, labels, catalog,
                                                  nodes_only):
    """fit()'s stored grids equal JAX's (the exact-union neighbour
    indices and counts exactly), and predict() on them matches."""
    som, port = trained
    kw = dict(nodes_only=nodes_only, verbose=False, batch_size=16,
              max_neighbors=256, track_scale=True)
    som.fit(*catalog, **kw)
    port.fit(*catalog, **kw)
    np.testing.assert_array_equal(port.neighbors, som.neighbors)
    np.testing.assert_array_equal(port.Nneighbors, som.Nneighbors)
    np.testing.assert_array_equal(port.fit_Ndim, som.fit_Ndim)
    for name in ("fit_lnprob", "fit_lnlike", "fit_chi2", "fit_scale"):
        g, w = getattr(port, name), getattr(som, name)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    args = (labels["zlab"], labels["zerr"])
    for lab in ("grid", "dict"):
        want = som.predict(*args, return_gof=True, verbose=False,
                           **labels["jax"][lab])
        got = port.predict(*args, return_gof=True, verbose=False,
                           **labels["port"][lab])
        _assert_fp_close(got, want)


def test_discrete_fit_predict_matches_jax(trained, labels, catalog):
    som, port = trained
    args = catalog + (labels["zlab"], labels["zerr"])
    for nodes_only in (True, False):
        kw = dict(nodes_only=nodes_only, discrete=True, verbose=False,
                  batch_size=16, max_neighbors=512, return_gof=True,
                  save_fits=False, label_grid=labels["grid"])
        _assert_fp_close(port.fit_predict(*args, **kw),
                         som.fit_predict(*args, **kw))


@pytest.mark.parametrize("nodes_only", [True, False])
def test_fit_summarize_matches_jax(trained, labels, catalog, nodes_only):
    som, port = trained
    args = catalog + (labels["zlab"], labels["zerr"])
    kw = dict(nodes_only=nodes_only, verbose=False, batch_size=16,
              max_neighbors=512, label_grid=labels["grid"])
    want, gof_w = som.fit_summarize(*args, **kw)
    got, gof_g = port.fit_summarize(*args, **kw)
    for g, w in zip(got[:4], want[:4]):
        for gc, wc in zip(g, w):
            np.testing.assert_allclose(gc, np.asarray(wc), rtol=2e-3,
                                       atol=2e-4)
    for gc, wc in zip(got[4:], want[4:]):
        np.testing.assert_allclose(gc, np.asarray(wc), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(gof_g[0], gof_w[0], **GOF_TOL)
    # The streamed summary equals the summary of the streamed PDFs.
    pdfs, gof = port.fit_predict(*args, return_gof=True, save_fits=False,
                                 **kw)
    np.testing.assert_array_equal(gof[0], gof_g[0])


def test_union_cap_raises(trained, catalog):
    som, port = trained
    for save_fits in (True, False):
        with pytest.raises(ValueError, match="max_neighbors"):
            port.fit_predict(*catalog, np.zeros(400), np.full(400, 0.05),
                             label_grid=np.linspace(0, 3, 31),
                             wt_thresh=1e-6, max_sel_nodes=16,
                             max_neighbors=8, save_fits=save_fits,
                             verbose=False)


def test_unported_options_raise(trained, catalog):
    """The mesh= refusal of the JAX fitter (networks.py:1011-1013) and a
    mesh that is not a `parallel.Mesh`."""
    from frankenz_tpu_torch.parallel import make_mesh

    _, port = trained
    labels = (np.zeros(400), np.full(400, 0.05))
    grid = np.linspace(0, 3, 31)
    with pytest.raises(TypeError, match="Mesh"):
        port.fit_predict(*catalog, *labels, label_grid=grid, mesh=object(),
                         save_fits=False)
    with pytest.raises(ValueError, match="save_fits=False"):
        port.fit_predict(*catalog, *labels, label_grid=grid,
                         mesh=make_mesh(devices=["cpu"] * 2))
    # Checkpoints are ported: a plan without a file fails fast.
    with pytest.raises(ValueError, match="checkpoint_file"):
        port.fit(*catalog, checkpoint_every=1)


def test_schedules_and_kernels_match_jax():
    import frankenz_tpu.models.networks as JN

    t = np.float32(0.37)
    for name in ("learn_linear", "learn_geometric", "learn_harmonic"):
        np.testing.assert_allclose(
            float(getattr(TN, name)(torch.tensor(t), start=0.6, end=0.05)),
            float(getattr(JN, name)(t, start=0.6, end=0.05)), rtol=1e-6)
    pos = np.array([1.0, 2.0], np.float32)
    positions = np.array([[0, 0], [1, 2], [3, 4], [2, 2]], np.float32)
    for name in ("neighbor_gauss", "neighbor_lorentz"):
        got, sig = getattr(TN, name)(torch.tensor(t), torch.tensor(pos),
                                     torch.tensor(positions), 5)
        want, sig_w = getattr(JN, name)(t, pos, positions, 5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        np.testing.assert_allclose(float(sig), float(sig_w), rtol=1e-6)


@pytest.mark.parametrize("cdf", [False, True])
def test_threshold_sel_matches_jax(cdf):
    import frankenz_tpu.models.networks as JN

    rng = np.random.default_rng(4)
    lnp = rng.normal(0, 3, (7, 50))
    lnp[2, :10] = -np.inf
    kw = dict(wt_thresh=None, cdf_thresh=0.05) if cdf else \
        dict(wt_thresh=1e-2, cdf_thresh=None)
    got = TN._threshold_sel(torch.tensor(lnp), **kw).numpy()
    np.testing.assert_array_equal(got, np.asarray(JN._threshold_sel(lnp,
                                                                    **kw)))
