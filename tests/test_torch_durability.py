"""Port parity for checkpoint / resume: every fitter's ``checkpoint_every``
/ ``resume`` and both training routes run in segments (the mirror of
tests/test_durability.py, case for case, at its sizes: 60 models, 40
objects; the kNN case whose crash follows a saved batch fits 600).

A run is killed by wrapping the module-level step its loop calls once a
batch or once a segment (`bruteforce._bf_lprob`, `knn._search`,
`networks._node_fit` / `_gather_union`, `networks._som_train_general`,
`kernels.som.som_train`, `networks._gng_train_general`,
`kernels.gng.gng_train`) so that it raises after a number of calls, then
resumed from the checkpoint file.  The port's segmented, killed and
resumed results equal its uninterrupted call bit for bit, on the general
routes and on the kernel routes' plain versions (``use_kernel=True`` on
CPU tensors).  Each resumed result is also held against the JAX
package's uninterrupted call on the same seed, at the tolerances of the
parity tests: BruteForce grids rtol / atol 1e-5 (test_torch_bruteforce);
kNN neighbours equal but among near ties (fewer than 1% of rows) and
grids rtol 1e-6 on the rows whose lists agree (test_torch_knn); network fits
neighbours equal and grids rtol / atol 1e-5 on a JAX-trained map carried
across (test_torch_networks); SOM nodes rtol / atol 2e-4; GNG nodes
rtol / atol 2e-4, node errors rtol 1e-4 / atol 0.1 and edge ages equal,
against JAX's `lax.scan` route (test_torch_gng).  Then the checkpoint
format: the port reads a JAX npz checkpoint, refuses Orbax, and carries
a sampler's chain across a save.
"""

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from frankenz_tpu.models import BruteForce as JaxBF
from frankenz_tpu.models import GrowingNeuralGas as JaxGNG
from frankenz_tpu.models import NearestNeighbors as JaxNN
from frankenz_tpu.models import SelfOrganizingMap as JaxSOM
from frankenz_tpu.utils import save as jax_save
from frankenz_tpu_torch.kernels import gng as GG
from frankenz_tpu_torch.kernels import som as SK
from frankenz_tpu_torch.models import (BruteForce, GrowingNeuralGas,
                                       NearestNeighbors, SelfOrganizingMap)
from frankenz_tpu_torch.models import bruteforce as bf_mod
from frankenz_tpu_torch.models import knn as knn_mod
from frankenz_tpu_torch.models import networks as net_mod
from frankenz_tpu_torch.samplers import hierarchical_sampler
from frankenz_tpu_torch.utils import (load_state_dict, network_from_jax,
                                      restore, save, state_dict)
from frankenz_tpu_torch.utils import checkpoint as ckpt

BF_TOL = dict(rtol=1e-5, atol=1e-5)
KNN_TOL = dict(rtol=1e-6, atol=1e-9)
FIT_TOL = dict(rtol=1e-5, atol=1e-5)
NODE_TOL = dict(rtol=2e-4, atol=2e-4)
ERR_TOL = dict(rtol=1e-4, atol=0.1)
SOM_KW = dict(nside=4, nproj=2, niter=20, nbatch=5, seed=9, verbose=False)
GNG_KW = dict(niter=30, nbatch=5, max_nodes=20, seed=4, verbose=False)


@pytest.fixture()
def problem():
    rng = np.random.default_rng(17)
    models = rng.uniform(1, 10, (60, 4))
    data = models[rng.integers(0, 60, 40)] + rng.normal(0, 0.2, (40, 4))
    derr = np.full_like(data, 0.2)
    dmask = np.ones_like(data)
    return models, data, derr, dmask


def _mods(models):
    return models, 0.05 * models, np.ones_like(models)


def _bomb_after(monkeypatch, module, name, ncalls):
    """Replace module.name with a wrapper raising after `ncalls` calls."""
    orig = getattr(module, name)
    state = {"n": 0}

    def wrapper(*a, **k):
        state["n"] += 1
        if state["n"] > ncalls:
            raise RuntimeError("simulated crash")
        return orig(*a, **k)

    monkeypatch.setattr(module, name, wrapper)
    return orig


def _assert_grids_close(got, want, tol, names=("fit_lnprob", "fit_lnlike",
                                                "fit_chi2")):
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], **tol, err_msg=name)


def _assert_same_fits(got, want, names=("fit_lnprior", "fit_lnlike",
                                        "fit_lnprob", "fit_Ndim",
                                        "fit_chi2")):
    for name in names:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def test_bruteforce_fit_kill_and_resume(tmp_path, problem, monkeypatch):
    models, data, derr, dmask = problem
    ck = str(tmp_path / "bf_ck")

    ref = BruteForce(*_mods(models), device="cpu")
    ref.fit(data, derr, dmask, batch_size=8, verbose=False)

    orig = _bomb_after(monkeypatch, bf_mod, "_bf_lprob", 2)
    crashed = BruteForce(*_mods(models), device="cpu")
    with pytest.raises(RuntimeError, match="simulated crash"):
        crashed.fit(data, derr, dmask, batch_size=8, checkpoint_every=1,
                    checkpoint_file=ck, verbose=False)
    assert crashed._fit_rows_done == 16  # two completed batches
    assert int(restore(ck)["_fit_rows_done"]) == 16
    monkeypatch.setattr(bf_mod, "_bf_lprob", orig)

    resumed = BruteForce(*_mods(models), device="cpu")
    resumed.fit(data, derr, dmask, batch_size=8, checkpoint_every=1,
                checkpoint_file=ck, resume=True, verbose=False)
    _assert_same_fits(resumed, ref)
    assert resumed._fit_rows_done == 40

    jax_ref = JaxBF(*_mods(models))
    jax_ref.fit(data, derr, dmask, batch_size=8, verbose=False)
    _assert_grids_close(resumed, jax_ref, BF_TOL)
    np.testing.assert_array_equal(resumed.fit_Ndim, jax_ref.fit_Ndim)


def _knn_problem(problem, nobj):
    models = problem[0]
    rng = np.random.default_rng(23)
    data = models[rng.integers(0, 60, nobj)] + rng.normal(0, 0.2, (nobj, 4))
    return data, np.full_like(data, 0.2), np.ones_like(data)


@pytest.mark.parametrize("nobj, crash_after", [
    (40, 0),    # one batch (the batch clamps to >= 256): nothing saved
    (600, 1),   # three 256-row batches: the crash follows a saved batch
])
def test_knn_fit_kill_and_resume(tmp_path, problem, monkeypatch, nobj,
                                 crash_after):
    """The resumed fit skips the saved batches but still draws their query
    jitter, so the remaining draws line up with the uninterrupted fit."""
    models = problem[0]
    data, derr, dmask = (problem[1:] if nobj == 40
                         else _knn_problem(problem, nobj))
    ck = str(tmp_path / "knn_ck")
    mk = dict(K=3, seed=0, verbose=False)
    fk = dict(k=4, batch_size=256, verbose=False)

    ref = NearestNeighbors(*_mods(models), device="cpu", **mk)
    ref.fit(data, derr, dmask, rng=np.random.default_rng(5), **fk)

    orig = _bomb_after(monkeypatch, knn_mod, "_search", crash_after)
    crashed = NearestNeighbors(*_mods(models), device="cpu", **mk)
    with pytest.raises(RuntimeError, match="simulated crash"):
        crashed.fit(data, derr, dmask, rng=np.random.default_rng(5),
                    checkpoint_every=1, checkpoint_file=ck, **fk)
    monkeypatch.setattr(knn_mod, "_search", orig)
    assert ckpt.exists(ck) == (crash_after > 0)

    resumed = NearestNeighbors(*_mods(models), device="cpu", **mk)
    resumed.fit(data, derr, dmask, rng=np.random.default_rng(5),
                checkpoint_every=1, checkpoint_file=ck, resume=True, **fk)
    np.testing.assert_array_equal(resumed.neighbors, ref.neighbors)
    np.testing.assert_array_equal(resumed.Nneighbors, ref.Nneighbors)
    _assert_same_fits(resumed, ref)
    assert resumed._fit_rows_done == nobj

    jax_ref = JaxNN(*_mods(models), **mk)
    jax_ref.fit(data, derr, dmask, rng=np.random.default_rng(5), **fk)
    same = _same_neighbor_rows(resumed, jax_ref, data, derr, dmask, k=4)
    for name in ("fit_lnprob", "fit_lnlike", "fit_chi2"):
        g, w = getattr(resumed, name)[same], getattr(jax_ref, name)[same]
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], **KNN_TOL, err_msg=name)


def _same_neighbor_rows(got, want, data, derr, dmask, k):
    """test_torch_knn's rule for the search against JAX: lists equal row
    for row, but for rows with a near tie (`knn._near_ties`, the queries'
    features rebuilt from the same jitter draws), where only near-equal
    candidates may differ, on fewer than 1% of rows.  Returns the rows
    whose lists are equal."""
    q = torch.cat([got._query_features(jq, de)[:n] for _, n, jq, _, de, _
                   in got._data_batches(data, derr, dmask, 256,
                                        np.random.default_rng(5), False,
                                        "")])
    ties, cands = knn_mod._near_ties(q, got.features, k)
    a, b = got.neighbors, np.asarray(want.neighbors)
    diff = np.nonzero((a != b).any(axis=1))[0]
    for r in diff:
        assert ties[r], f"row {r} differs without a near tie"
        moved = set(a[r][a[r] >= 0]) ^ set(b[r][b[r] >= 0])
        assert all(cands[r][m] for m in moved), \
            f"row {r} differs outside its near ties"
    assert len(diff) < 0.01 * len(a), f"rows {diff.tolist()} differ"
    same = np.ones(len(a), bool)
    same[diff] = False
    np.testing.assert_array_equal(got.Nneighbors[same],
                                  np.asarray(want.Nneighbors)[same])
    return same


def test_knn_resume_needs_the_skipped_jitter(tmp_path, problem):
    """A resume whose generator did not draw the skipped batch's jitter
    (a fresh generator started at the second batch) gives other
    neighbours: the draw of skipped batches is what keeps resume exact."""
    models = problem[0]
    data, derr, dmask = _knn_problem(problem, 600)
    mk = dict(K=3, seed=0, verbose=False)
    fk = dict(k=4, batch_size=256, verbose=False)
    ref = NearestNeighbors(*_mods(models), device="cpu", **mk)
    ref.fit(data, derr, dmask, rng=np.random.default_rng(5), **fk)
    part = NearestNeighbors(*_mods(models), device="cpu", **mk)
    part.fit(data[:256], derr[:256], dmask[:256],
             rng=np.random.default_rng(5), **fk)
    np.testing.assert_array_equal(part.neighbors, ref.neighbors[:256])
    rest = NearestNeighbors(*_mods(models), device="cpu", **mk)
    rest.fit(data[256:], derr[256:], dmask[256:],
             rng=np.random.default_rng(5), **fk)
    assert not np.array_equal(rest.fit_lnprob, ref.fit_lnprob[256:])


@pytest.fixture()
def jax_trained_som(problem):
    models = problem[0]
    som = JaxSOM(*_mods(models))
    som.train_network(nside=4, nproj=2, niter=10, nbatch=5, seed=3,
                      verbose=False)
    som.populate_network(verbose=False)
    return som


@pytest.mark.parametrize("nodes_only, step", [(True, "_node_fit"),
                                              (False, "_gather_union")])
def test_network_fit_kill_and_resume(tmp_path, problem, monkeypatch,
                                     jax_trained_som, nodes_only, step):
    _, data, derr, dmask = problem
    ck = str(tmp_path / "net_ck")
    kw = dict(nodes_only=nodes_only, batch_size=8, verbose=False,
              max_neighbors=128)

    def build():
        return network_from_jax(jax_trained_som, device="cpu")

    ref = build()
    ref.fit(data, derr, dmask, **kw)

    crashed = build()
    orig = _bomb_after(monkeypatch, net_mod, step, 2)
    with pytest.raises(RuntimeError, match="simulated crash"):
        crashed.fit(data, derr, dmask, checkpoint_every=1,
                    checkpoint_file=ck, **kw)
    monkeypatch.setattr(net_mod, step, orig)
    assert int(restore(ck)["_fit_rows_done"]) == 16

    resumed = build()
    resumed.fit(data, derr, dmask, checkpoint_every=1, checkpoint_file=ck,
                resume=True, **kw)
    np.testing.assert_array_equal(resumed.neighbors, ref.neighbors)
    np.testing.assert_array_equal(resumed.Nneighbors, ref.Nneighbors)
    _assert_same_fits(resumed, ref)

    jax_trained_som.fit(data, derr, dmask, **kw)
    np.testing.assert_array_equal(resumed.neighbors,
                                  jax_trained_som.neighbors)
    np.testing.assert_array_equal(resumed.Nneighbors,
                                  jax_trained_som.Nneighbors)
    np.testing.assert_array_equal(resumed.fit_Ndim, jax_trained_som.fit_Ndim)
    _assert_grids_close(resumed, jax_trained_som, FIT_TOL)


def _som(models, **kw):
    som = SelfOrganizingMap(*_mods(models), device="cpu")
    som.train_network(**{**SOM_KW, **kw})
    return som


@pytest.mark.parametrize("use_kernel", [False, True])
def test_som_chunked_training_matches_single_call(tmp_path, problem,
                                                  use_kernel):
    models = problem[0]
    ref = _som(models, use_kernel=use_kernel)
    som = _som(models, use_kernel=use_kernel, checkpoint_every=30,
               checkpoint_file=str(tmp_path / "c1"))
    np.testing.assert_array_equal(som.nodes, ref.nodes)
    st = restore(str(tmp_path / "c1"))
    assert (int(st["steps_done"]), int(st["nsteps_total"])) == (100, 100)
    np.testing.assert_array_equal(st["nodes"], ref.nodes)

    jax_ref = JaxSOM(*_mods(models))
    jax_ref.train_network(**SOM_KW)  # lax.scan: no Pallas on the CPU
    np.testing.assert_allclose(som.nodes, jax_ref.nodes, **NODE_TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_som_training_kill_and_resume(tmp_path, problem, monkeypatch,
                                      use_kernel):
    models = problem[0]
    ck = str(tmp_path / "som_ck")
    ref = _som(models, use_kernel=use_kernel)

    module, name = ((SK, "som_train") if use_kernel
                    else (net_mod, "_som_train_general"))
    orig = _bomb_after(monkeypatch, module, name, 2)
    with pytest.raises(RuntimeError, match="simulated crash"):
        _som(models, use_kernel=use_kernel, checkpoint_every=25,
             checkpoint_file=ck)
    monkeypatch.setattr(module, name, orig)
    assert int(restore(ck)["steps_done"]) == 50

    calls = []
    monkeypatch.setattr(module, name, _counted(orig, calls))
    resumed = _som(models, use_kernel=use_kernel, checkpoint_every=25,
                   checkpoint_file=ck, resume=True)
    assert len(calls) == 2  # the two segments left
    np.testing.assert_array_equal(resumed.nodes, ref.nodes)

    jax_ref = JaxSOM(*_mods(models))
    jax_ref.train_network(**SOM_KW)
    np.testing.assert_allclose(resumed.nodes, jax_ref.nodes, **NODE_TOL)

    # A checkpoint of another run length is refused.
    with pytest.raises(ValueError, match="step run"):
        _som(models, use_kernel=use_kernel, checkpoint_every=25,
             checkpoint_file=ck, resume=True, niter=21)


def _counted(fn, calls):
    def wrapper(*a, **k):
        calls.append(1)
        return fn(*a, **k)
    return wrapper


def _gng(models, **kw):
    gng = GrowingNeuralGas(*_mods(models), device="cpu")
    gng.train_network(**{**GNG_KW, **kw})
    return gng


def _assert_same_graph(got, want):
    np.testing.assert_array_equal(got.nodes, want.nodes)
    np.testing.assert_array_equal(got.nodes_err, want.nodes_err)
    np.testing.assert_array_equal(got.edge_ages, want.edge_ages)
    assert got.edge_overflow == want.edge_overflow


@pytest.mark.parametrize("use_kernel", [False, True])
def test_gng_chunked_training_and_resume(tmp_path, problem, monkeypatch,
                                         use_kernel):
    models = problem[0]
    ck = str(tmp_path / "gng_ck")
    ref = _gng(models, use_kernel=use_kernel)

    # Chunked == single call, bit for bit (40 steps round up to 40: whole
    # nbatch blocks).
    gng = _gng(models, use_kernel=use_kernel, checkpoint_every=38,
               checkpoint_file=str(tmp_path / "c3"))
    _assert_same_graph(gng, ref)
    st = restore(str(tmp_path / "c3"))
    assert sorted(st) == sorted(["pos", "err", "alive", "ids", "sref", "c",
                                 "overflow", "steps_done", "nsteps_total"])
    assert int(st["steps_done"]) == 150

    # Kill after two segments, resume to identical results.
    module, name = ((GG, "gng_train") if use_kernel
                    else (net_mod, "_gng_train_general"))
    orig = _bomb_after(monkeypatch, module, name, 2)
    with pytest.raises(RuntimeError, match="simulated crash"):
        _gng(models, use_kernel=use_kernel, checkpoint_every=40,
             checkpoint_file=ck)
    monkeypatch.setattr(module, name, orig)
    assert int(restore(ck)["steps_done"]) == 80
    resumed = _gng(models, use_kernel=use_kernel, checkpoint_every=40,
                   checkpoint_file=ck, resume=True)
    _assert_same_graph(resumed, ref)

    jax_ref = JaxGNG(*_mods(models))
    jax_ref.train_network(use_pallas=False, **GNG_KW)
    assert resumed.NNODE == jax_ref.NNODE
    np.testing.assert_array_equal(resumed.edge_ages, jax_ref.edge_ages)
    np.testing.assert_allclose(resumed.nodes, jax_ref.nodes, **NODE_TOL)
    np.testing.assert_allclose(resumed.nodes_err, jax_ref.nodes_err,
                               **ERR_TOL)


def test_checkpoint_every_without_file_fails_fast(problem, monkeypatch):
    """checkpoint_every without checkpoint_file raises before any batch or
    segment runs."""
    models, data, derr, dmask = problem
    for module, name in ((bf_mod, "_bf_lprob"), (knn_mod, "_search"),
                         (net_mod, "_som_train_general"),
                         (net_mod, "_gng_train_general"),
                         (SK, "som_train"), (GG, "gng_train")):
        _bomb_after(monkeypatch, module, name, 0)
    bf = BruteForce(*_mods(models), device="cpu")
    with pytest.raises(ValueError, match="checkpoint_file"):
        bf.fit(data, derr, dmask, checkpoint_every=2, verbose=False)
    nn = NearestNeighbors(*_mods(models), K=2, seed=0, verbose=False,
                          device="cpu")
    with pytest.raises(ValueError, match="checkpoint_file"):
        nn.fit(data, derr, dmask, k=3, checkpoint_every=2, verbose=False)
    for use_kernel in (False, True):
        som = SelfOrganizingMap(*_mods(models), device="cpu")
        with pytest.raises(ValueError, match="checkpoint_file"):
            som.train_network(nside=3, nproj=2, niter=4, nbatch=2, seed=0,
                              checkpoint_every=4, verbose=False,
                              use_kernel=use_kernel)
        gng = GrowingNeuralGas(*_mods(models), device="cpu")
        with pytest.raises(ValueError, match="checkpoint_file"):
            gng.train_network(niter=4, nbatch=2, max_nodes=10, seed=0,
                              checkpoint_every=4, verbose=False,
                              use_kernel=use_kernel)
    with pytest.raises(ValueError, match="positive"):
        bf.fit(data, derr, dmask, checkpoint_every=-1, checkpoint_file="x",
               verbose=False)


def test_restore_reads_a_jax_bruteforce_checkpoint(tmp_path, problem):
    """The port's `restore` reads what JAX's ``save(..., use_orbax=False)``
    writes: the same keys, shapes and dtypes as the port's own state after
    the same fit, and the JAX fits land on a port BruteForce."""
    models, data, derr, dmask = problem
    jbf = JaxBF(*_mods(models))
    jbf.fit(data, derr, dmask, batch_size=8, verbose=False)
    path = jax_save(str(tmp_path / "jax_bf"), jbf, use_orbax=False)
    tbf = BruteForce(*_mods(models), device="cpu")
    tbf.fit(data, derr, dmask, batch_size=8, verbose=False)
    mine = state_dict(tbf)
    theirs = restore(path)
    assert sorted(theirs) == sorted(mine)
    for k in mine:
        got, want = np.asarray(mine[k]), theirs[k]
        assert (got.shape, got.dtype) == (want.shape, want.dtype), k
    carried = restore(path, BruteForce(*_mods(models), device="cpu"))
    for k in ("fit_lnprob", "fit_chi2", "fit_Ndim"):
        np.testing.assert_array_equal(getattr(carried, k),
                                      np.asarray(getattr(jbf, k)))
    assert carried.NDATA == 40 and carried._fit_rows_done == 40
    _assert_grids_close(tbf, carried, BF_TOL)


def test_npz_only(tmp_path, problem):
    """No Orbax on the card's machine: use_orbax=True and a directory
    raise; None and False write npz."""
    models, data, derr, dmask = problem
    bf = BruteForce(*_mods(models), device="cpu")
    bf.fit(data, derr, dmask, verbose=False)
    with pytest.raises(ValueError, match="npz"):
        save(str(tmp_path / "o"), bf, use_orbax=True)
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(ValueError, match="Orbax"):
        restore(str(tmp_path / "orbax_dir"))
    for flag in (None, False):
        path = save(str(tmp_path / f"bf_{flag}"), bf, use_orbax=flag)
        assert (tmp_path / f"bf_{flag}.npz").exists()
        np.testing.assert_array_equal(restore(path)["fit_lnprob"],
                                      bf.fit_lnprob)


def test_knn_features_come_back_as_tensors(tmp_path, problem):
    """An attribute the port keeps as a tensor on the object's device (the
    kNN features) is restored as one, with its squared norms."""
    models, data, derr, dmask = problem
    nn = NearestNeighbors(*_mods(models), K=3, seed=2, verbose=False,
                          device="cpu")
    nn.fit(data, derr, dmask, k=5, verbose=False,
           rng=np.random.default_rng(1))
    path = save(str(tmp_path / "knn"), nn)
    nn2 = NearestNeighbors(*_mods(models), K=3, seed=7, verbose=False,
                           device="cpu")
    restore(path, nn2)
    assert isinstance(nn2.features, torch.Tensor)
    assert nn2.features.dtype == torch.float32
    assert torch.equal(nn2.features, nn.features)
    assert torch.equal(nn2.features_sqnorm, nn.features_sqnorm)
    np.testing.assert_array_equal(nn2.neighbors, nn.neighbors)
    assert nn2.k == 5 and nn2.NDATA == 40


def test_sampler_checkpoint_resume(tmp_path):
    """tests/test_utils.py's sampler round trip: the chain and its
    `_chain_state` survive a save, and the restored sampler continues as
    the original does."""
    rng = np.random.default_rng(2)
    pdfs = rng.dirichlet(np.ones(10), size=50)
    s = hierarchical_sampler(pdfs, device="cpu")
    s.run_mcmc(5, thin=2, seed=1, verbose=False)
    path = save(str(tmp_path / "chain"), s)
    s2 = hierarchical_sampler(pdfs, device="cpu")
    restore(path, s2)
    assert len(s2.samples) == 5
    np.testing.assert_array_equal(s2._chain_state, s._chain_state)
    s2.run_mcmc(3, thin=2, seed=2, verbose=False)
    s.run_mcmc(3, thin=2, seed=2, verbose=False)
    assert len(s2.samples) == 8
    np.testing.assert_array_equal(np.asarray(s2.samples),
                                  np.asarray(s.samples))
    load_state_dict(s2, state_dict(s))
    np.testing.assert_array_equal(s2._chain_state, s._chain_state)
