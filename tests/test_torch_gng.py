"""Port parity for the GrowingNeuralGas path: training on both routes,
the seed state of `graph_init`, resumed training, and populate / node
PDFs / nodes-only fit_predict on a GNG carried across from JAX; and the
NaN-band repair of both training kernels' plain versions.

The same NumPy inputs go through `frankenz_tpu`'s GrowingNeuralGas (on
the CPU, x64; its Pallas kernel in interpret mode, or its `lax.scan`)
and the port's (on CPU tensors: the `gng_train` kernel's plain version,
or the general step loop).  Tolerances: nodes rtol / atol 2e-4 (the
SOM's `NODE_TOL`), node errors rtol 1e-4 with atol 0.1 (each is a
decayed sum of chi^2 values, each off by a few spacings of A, 0.002 on
the blob problem, over up to ~50 best-node events: see below), edge ages, node counts and the edge overflow
equal; populate and PDFs at tests/test_torch_networks.py's
tolerances.

The runs are held to JAX where their trajectories stay locked.  A GNG
step's score is chi^2 = A - inter^2 / shape, a difference of numbers of
~1e4 on the blob problem, so it is quantized at A's float32 spacing, and
two nodes whose scores differ by one quantum swap ranks under one ulp of
difference in a filter sum.  JAX on the CPU contracts a * b + c into one
fused multiply-add; the port rounds every operation.  So the blob runs
use seed 6: at the seed of tests/test_networks.py (5) one such swap, in
block 31 of 40, sends both port routes off JAX's trajectory (JAX's two
routes contract alike and stay together).
"""

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from frankenz_tpu.models import GrowingNeuralGas as JaxGNG
from frankenz_tpu.models import SelfOrganizingMap as JaxSOM
from frankenz_tpu.models import networks as JN
from frankenz_tpu.ops import likelihood as JL
from frankenz_tpu_torch.kernels import gng as GG
from frankenz_tpu_torch.kernels import som as SK
from frankenz_tpu_torch.models import GrowingNeuralGas, SelfOrganizingMap
from frankenz_tpu_torch.models import networks as TN
from frankenz_tpu_torch.ops import likelihood as TL
from frankenz_tpu_torch.utils import network_from_jax

NODE_TOL = dict(rtol=2e-4, atol=2e-4)
ERR_TOL = dict(rtol=1e-4, atol=0.1)
PDF_TOL = dict(rtol=2e-3, atol=2e-5)
GOF_TOL = dict(rtol=1e-5, atol=1e-6)
GNG_KW = dict(niter=40, nbatch=25, max_nodes=30, seed=6, verbose=False)
CENTERS3 = np.array([[2.0, 5.0, 8.0], [8.0, 3.0, 2.0], [5.0, 9.0, 4.0],
                     [9.0, 8.0, 7.0]])


@pytest.fixture(scope="module")
def blob_problem():
    """tests/test_networks.py's blobs: 4 clusters in 3-band flux space,
    a redshift label tied to the cluster."""
    rng = np.random.default_rng(42)
    zc = np.array([0.3, 1.0, 1.8, 2.6])
    models = np.vstack([c + rng.normal(0, 0.3, (100, 3)) for c in CENTERS3])
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


@pytest.fixture(scope="module")
def nan_problem():
    """4 blobs x 60 models over 3 filters; model 17 holds NaN in band 1,
    which its mask drops."""
    rng = np.random.default_rng(42)
    models = np.vstack([c + rng.normal(0, 0.3, (60, 3)) for c in CENTERS3])
    mm = np.ones_like(models)
    models[17, 1] = np.nan
    mm[17, 1] = 0.0
    return models, np.full_like(models, 0.05), mm


def _both(problem, jax_kw, torch_kw, **kw):
    a = JaxGNG(*problem[:3])
    a.train_network(**jax_kw, **kw)
    b = GrowingNeuralGas(*problem[:3], device="cpu")
    b.train_network(**torch_kw, **kw)
    return a, b


def _assert_gng_close(got, want):
    assert (got.NNODE, got.edge_overflow) == (want.NNODE, want.edge_overflow)
    assert got.nodes.shape == want.nodes.shape
    assert got.nodes.dtype == np.float64
    np.testing.assert_array_equal(got.edge_ages, want.edge_ages)
    err = np.abs(got.nodes - want.nodes)
    np.testing.assert_allclose(got.nodes, want.nodes, **NODE_TOL,
                               err_msg=f"max abs {err.max():.3g}")
    np.testing.assert_allclose(got.nodes_err, want.nodes_err, **ERR_TOL)
    np.testing.assert_array_equal(got.nodes_pos, got.nodes[:, :2])
    assert got.NPROJ == want.NPROJ


@pytest.mark.parametrize("which", ["blob", "masked"])
def test_kernel_route_matches_the_pallas_kernel(blob_problem, masked_problem,
                                                which):
    """The plain version of `gng_train` against JAX's mega-kernel
    (interpret mode) from the same numpy draws."""
    problem = blob_problem if which == "blob" else masked_problem
    a, b = _both(problem, dict(use_pallas=True), dict(use_kernel=True),
                 **GNG_KW)
    _assert_gng_close(b, a)
    assert b.NNODE == 30 and len(b.edges()) > 0
    # On CPU tensors the default route is the kernel route.
    c = GrowingNeuralGas(*problem[:3], device="cpu")
    c.train_network(**GNG_KW)
    np.testing.assert_array_equal(c.nodes, b.nodes)
    np.testing.assert_array_equal(c.edge_ages, b.edge_ages)


def _hub_graph():
    """A hub node holding 32 edges, a twin of it at the data that is not
    joined to it (its one edge goes elsewhere), and the leaves."""
    rng = np.random.default_rng(3)
    leaves = CENTERS3[1:][rng.integers(0, 3, 32)] + rng.normal(0, 0.5,
                                                                (32, 3))
    pos = np.vstack([CENTERS3[0], CENTERS3[0] * 1.001, leaves,
                     CENTERS3[3] + 0.1])
    return {"pos": pos,
            "edges": [(0, 2 + k, 0) for k in range(32)] + [(1, 34, 0)]}


def test_overflow_hub_follows_each_jax_route(blob_problem):
    """The hub's full slots drop the edge to its twin on one side: the
    adjacency turns one-sided, and JAX's two routes part (the Pallas
    kernel moves the nodes whose slots hold the best node, the scan the
    nodes in the best node's slots).  The port's kernel route follows
    the Pallas kernel, its general route the scan."""
    kw = dict(niter=4, nbatch=25, max_nodes=40, max_age=1000, seed=7,
              verbose=False)
    out = {}
    for name, jax_kw, torch_kw in (
            ("kernel", dict(use_pallas=True), dict(use_kernel=True)),
            ("general", dict(use_pallas=False), dict(use_kernel=False))):
        out[name] = _both(blob_problem, jax_kw, torch_kw,
                          graph_init=_hub_graph(), **kw)
    (jp, tk), (js, tg) = out["kernel"], out["general"]
    assert jp.edge_overflow > 0 and js.edge_overflow > 0
    assert not np.allclose(jp.nodes, js.nodes, **NODE_TOL)
    _assert_gng_close(tk, jp)
    _assert_gng_close(tg, js)


def _jax_lprob(*args, **kwargs):
    return JL.logprob(*args, **kwargs)


def _port_lprob(*args, **kwargs):
    return TL.logprob(*args, **kwargs)


@pytest.mark.parametrize("extra", ["default", "track_scale", "lprob_func"])
def test_general_route_matches_the_scan(blob_problem, extra):
    """`use_kernel=False` against JAX's `use_pallas=False` scan: the
    inlined default likelihood, `track_scale`, and a custom `lprob_func`
    (which takes the step through the likelihood module)."""
    jx, tx = {}, {}
    if extra == "track_scale":
        jx = tx = dict(track_scale=True)
    elif extra == "lprob_func":
        jx, tx = dict(lprob_func=_jax_lprob), dict(lprob_func=_port_lprob)
    a, b = _both(blob_problem, dict(use_pallas=False, **jx),
                 dict(use_kernel=False, **tx), **GNG_KW)
    _assert_gng_close(b, a)


@pytest.mark.parametrize("form", ["edges", "edge_ages", "trained",
                                  "networkx"])
def test_seed_state_matches_jax(blob_problem, form):
    models = blob_problem[0]
    if form == "edges":
        graph = {"pos": models[:5], "err": np.arange(5.0),
                 "edges": [(0, 1, 3), (1, 2), (3, 4, 7)]}
    elif form == "edge_ages":
        ages = np.full((4, 4), -1)
        ages[0, 2] = ages[2, 0] = 5
        ages[1, 3] = ages[3, 1] = 0
        graph = {"pos": models[10:14], "edge_ages": ages}
    elif form == "trained":
        graph = JaxGNG(*blob_problem[:3])
        graph.train_network(niter=8, nbatch=25, max_nodes=30, seed=2,
                            use_pallas=False, verbose=False)
    else:
        nx = pytest.importorskip("networkx")
        graph = nx.Graph()
        graph.add_node("a", pos=models[0], error=0.5)
        graph.add_node("b", pos=models[100], error=0.0)
        graph.add_node("c", pos=models[200])
        graph.add_edge("a", "b", age=3)
        graph.add_edge("b", "c")
    want = JN._gng_seed_state(graph, 30, 3)
    got = TN._gng_seed_state(graph, 30, 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_seed_state_errors(blob_problem):
    models = blob_problem[0]
    for graph, err, match in (({"pos": models[:1]}, ValueError, "at least 2"),
                              ({"pos": models[:31]}, ValueError,
                               "max_nodes"),
                              (42, TypeError, "graph_init"),
                              ({"pos": models[:3, :2]}, ValueError,
                               "expected")):
        with pytest.raises(err, match=match):
            TN._gng_seed_state(graph, 30, 3)
    star = {"pos": models[:41], "edges": [(0, k) for k in range(1, 41)]}
    with pytest.raises(ValueError, match="more than 32"):
        TN._gng_seed_state(star, 60, 3)
    nx = pytest.importorskip("networkx")
    g = nx.Graph()
    g.add_node("a", pos=models[0])
    g.add_node("b")
    with pytest.raises(ValueError, match="pos"):
        TN._gng_seed_state(g, 30, 3)


class _FixedRng:
    """tests/test_networks.py's rng stand-in: a preset draw array and
    node pair, so split and continuous runs see the same stream."""

    def __init__(self, draws, pair=(0, 1)):
        self._draws = np.asarray(draws)
        self._pair = np.asarray(pair)

    def integers(self, low, high=None, size=None):
        assert size == len(self._draws)
        return self._draws

    def choice(self, n, size=2, replace=False):
        return self._pair


@pytest.mark.parametrize("use_kernel", [True, False])
def test_graph_init_resumes_training(blob_problem, use_kernel):
    """A run split into two train_network calls bridged by export_graph()
    (or by the trained instance itself) equals the uninterrupted run, as
    tests/test_networks.py:278-311 holds JAX to."""
    rng = np.random.default_rng(11)
    draws = rng.integers(0, len(blob_problem[0]), 600)
    kw = dict(nbatch=25, max_nodes=30, verbose=False, use_kernel=use_kernel)
    args = blob_problem[:3]

    full = GrowingNeuralGas(*args, device="cpu")
    full.train_network(niter=24, rng=_FixedRng(draws, (3, 7)), **kw)
    part = GrowingNeuralGas(*args, device="cpu")
    part.train_network(niter=12, rng=_FixedRng(draws[:300], (3, 7)), **kw)
    assert part.NNODE == 2 + 12
    for graph in (part.export_graph(), part):
        resumed = GrowingNeuralGas(*args, device="cpu")
        resumed.train_network(niter=12, rng=_FixedRng(draws[300:]),
                              graph_init=graph, **kw)
        assert resumed.NNODE == full.NNODE
        np.testing.assert_allclose(resumed.nodes, full.nodes, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(resumed.nodes_err, full.nodes_err,
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_array_equal(resumed.edge_ages, full.edge_ages)


@pytest.fixture(scope="module")
def carried(blob_problem):
    """A JAX-trained GNG (the scan), its port twin carried across before
    populate, both populated."""
    gng = JaxGNG(*blob_problem[:3])
    gng.train_network(use_pallas=False, **GNG_KW)
    port = network_from_jax(gng, device="cpu")
    gng.populate_network(verbose=False)
    port.populate_network(verbose=False)
    return gng, port


def test_network_from_jax_carries_a_trained_gng(carried):
    gng, port = carried
    assert isinstance(port, GrowingNeuralGas)
    np.testing.assert_array_equal(port.nodes, gng.nodes)
    np.testing.assert_array_equal(port.nodes_err, gng.nodes_err)
    np.testing.assert_array_equal(port.edge_ages, gng.edge_ages)
    assert port.edge_overflow == gng.edge_overflow
    np.testing.assert_array_equal(port.edges(), gng.edges())
    for name in ("nodes_idxs", "nodes_Nmatch", "nodes_bmus", "nodes_Nbmu"):
        np.testing.assert_array_equal(getattr(port, name), getattr(gng, name),
                                      err_msg=name)
    fin = np.isfinite(gng.nodes_logwts)
    np.testing.assert_array_equal(np.isfinite(port.nodes_logwts), fin)
    np.testing.assert_allclose(port.nodes_logwts[fin], gng.nodes_logwts[fin],
                               rtol=1e-5, atol=1e-6)
    exported = port.export_graph()
    for key, value in gng.export_graph().items():
        np.testing.assert_array_equal(exported[key], value)


def test_gng_pdfs_and_nodes_only_fit_predict_match_jax(carried,
                                                       blob_problem):
    gng, port = carried
    zlab = blob_problem[3]
    zerr = np.full_like(zlab, 0.05)
    grid = np.linspace(0, 3, 151)
    want = gng.get_pdfs(zlab, zerr, label_grid=grid, return_gof=True,
                        verbose=False)
    got = port.get_pdfs(zlab, zerr, label_grid=grid, return_gof=True,
                        verbose=False)
    np.testing.assert_allclose(got[0], want[0], **PDF_TOL)
    rng = np.random.default_rng(5)
    models = blob_problem[0]
    data = models[rng.integers(0, len(models), 40)] + rng.normal(
        0, 0.1, (40, 3))
    fit = (data, np.full_like(data, 0.1), np.ones_like(data), zlab, zerr)
    kw = dict(nodes_only=True, verbose=False, batch_size=16,
              return_gof=True, label_grid=grid)
    for save_fits in (True, False):
        want = gng.fit_predict(*fit, save_fits=save_fits, **kw)
        got = port.fit_predict(*fit, save_fits=save_fits, **kw)
        np.testing.assert_allclose(got[0], want[0], **PDF_TOL)
        np.testing.assert_allclose(got[1][0], want[1][0], **GOF_TOL)
        np.testing.assert_allclose(got[1][1], want[1][1], **GOF_TOL)


def test_use_kernel_true_refuses_an_ineligible_configuration(blob_problem):
    gng = GrowingNeuralGas(*blob_problem[:3], device="cpu")
    kw = dict(niter=1, nbatch=5, seed=0, verbose=False, use_kernel=True)
    for bad in (dict(track_scale=True), dict(lprob_func=_port_lprob),
                dict(lprob_kwargs={"free_scale": False}),
                dict(max_nodes=GG.MAX_NODES + 1)):
        with pytest.raises(ValueError, match="use_kernel"):
            gng.train_network(**kw, **bad)
    # Checkpoints are ported: a plan without a file fails fast.
    with pytest.raises(ValueError, match="checkpoint_file"):
        gng.train_network(niter=1, nbatch=5, checkpoint_every=5,
                          verbose=False)


def test_cuda_device_raises_without_a_card(blob_problem):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        GrowingNeuralGas(*blob_problem[:3], device="cuda")


# ---------------------------------------------------------------------
# The NaN-band repair: a node a step leaves alone keeps its value by
# selection, so a NaN in a masked band reaches only the nodes the step
# moves, as in JAX's scan routes (the Pallas kernels carry it to every
# node through 0 * NaN).
# ---------------------------------------------------------------------

@pytest.mark.parametrize("net", ["gng", "som"])
def test_nan_band_reaches_the_nodes_the_scan_moves(nan_problem, net):
    if net == "gng":
        kw = dict(niter=20, nbatch=25, max_nodes=20, seed=4, verbose=False)
        a, b = JaxGNG(*nan_problem), GrowingNeuralGas(*nan_problem,
                                                      device="cpu")
    else:
        kw = dict(nside=3, nproj=2, niter=30, nbatch=10, seed=3,
                  verbose=False)
        a, b = JaxSOM(*nan_problem), SelfOrganizingMap(*nan_problem,
                                                       device="cpu")
    a.train_network(use_pallas=False, **kw)
    b.train_network(use_kernel=True, **kw)
    nan = np.isnan(a.nodes)
    assert 0 < nan.any(axis=1).sum() < len(a.nodes)
    # The fault repaired: JAX's Pallas kernel carries the NaN everywhere.
    c = type(a)(*nan_problem)
    c.train_network(use_pallas=True, **kw)
    assert np.isnan(c.nodes).any(axis=1).all()
    np.testing.assert_array_equal(np.isnan(b.nodes), nan)
    np.testing.assert_allclose(b.nodes[~nan], a.nodes[~nan], **NODE_TOL)
    if net == "gng":
        np.testing.assert_array_equal(b.edge_ages, a.edge_ages)


def _som_plain_before_repair(nodes, pos, xc, iv, xr, *, nside, wt_thresh,
                             lr, nb):
    """`som_train_plain` as it was before the repair: every node moved by
    a (possibly zero) multiple of xr - node."""
    f32 = torch.float32

    def c(v):
        return torch.tensor(np.float32(v), dtype=f32)

    T, F = xc.shape
    nd = nodes.clone()
    xiv = xc * iv
    A = xc[:, 0] * xiv[:, 0]
    for f in range(1, F):
        A = A + xc[:, f] * xiv[:, f]
    a1 = c(0.5) * ((iv > 0).to(f32).sum(dim=1) - c(1.0)) - c(1.0)
    t = torch.arange(T, dtype=f32) * c(SK._inv_t(T))
    s2 = SK._learn_plain(nb, t, c) * c(nside)
    s2 = s2 * s2
    rate = SK._learn_plain(lr, t, c)
    for s in range(T):
        it, sh = nd * xiv[s], (nd * nd) * iv[s]
        inter, shape = it[:, 0], sh[:, 0]
        for f in range(1, F):
            inter, shape = inter + it[:, f], shape + sh[:, f]
        chi2 = A[s] - inter * (inter / torch.maximum(shape, c(1e-30)))
        score = a1[s] * torch.log(torch.maximum(chi2, c(1e-30))) \
            - c(0.5) * chi2
        diff = pos - pos[torch.argmax(score)]
        wt = torch.exp((-c(0.5) * (diff * diff).sum(dim=1)) / s2[s])
        u = torch.where(wt > c(wt_thresh) * wt.amax(), rate[s] * wt, c(0.0))
        nd = nd + u[:, None] * (xr[s] - nd)
    return nd


def test_som_repair_changes_no_bit_on_finite_inputs(masked_problem):
    """On finite inputs x + 0 * (finite) == x, so the selection leaves
    every bit of the trained table as it was."""
    models, me, mm = masked_problem
    rng = np.random.default_rng(12)
    nside = 4
    idx = np.arange(nside * nside)
    pos = np.stack([idx // nside, idx % nside], axis=1).astype(np.float32)
    init = models[rng.choice(len(models), nside * nside, replace=False)]
    draws = TN.som_kernel_draws(models, me, mm,
                                rng.integers(0, len(models), 300))
    t = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
         for a in (init, pos) + draws]
    kw = dict(nside=nside, wt_thresh=1e-3,
              lr=SK.schedule("harmonic", 0.5, 0.1),
              nb=SK.schedule("harmonic", 0.7, 0.02))
    got, _ = SK.som_train_plain(*t, **kw)
    assert torch.equal(got, _som_plain_before_repair(*t, **kw))
