"""Port parity for `parallel/` and every `mesh=`: meshes, the sharded,
model-sharded and ring steps, catalog input, the stacked N(z), and the
fitters and samplers under a mesh.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py
(`make_mesh(8)`), the port on a mesh of 8 shards of the one torch CPU
device (``make_mesh(devices=["cpu"] * 8)``), with the same NumPy inputs
from a seed.  Each `mesh=` entry point is held twice: against the port's
own single-device call at tests/test_parallel.py's mesh tolerances
(:237-244, :295, :336, :373-376), and against JAX's mesh call.  Where the
port's single-device route already differs from JAX's (its fused kernels
against JAX's XLA composition, the SOM path), the JAX comparison takes
that route's tolerance from its own parity test: PDFs rtol 1e-3 / atol
1e-5 (test_parallel.py:241's kernel-vs-composition bound), network PDFs
2e-3 / 2e-5 (tests/test_torch_networks.py), summaries 2e-3 / 2e-4
(tests/test_fit_summarize.py).  A one-shard mesh gives every fitter's
and sampler's single-device result bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from frankenz_tpu import parallel as JPL
from frankenz_tpu.models import BruteForce as JaxBruteForce
from frankenz_tpu.models import NearestNeighbors as JaxNN
from frankenz_tpu.models import SelfOrganizingMap as JaxSOM
from frankenz_tpu.ops import PDFDict as JaxPDFDict
from frankenz_tpu.ops import kde as JK
from frankenz_tpu.ops import summarize as JS
from frankenz_tpu.samplers import hierarchical_sampler as JaxHier
from frankenz_tpu.samplers import population_sampler as JaxPop
from frankenz_tpu_torch import parallel as PL
from frankenz_tpu_torch.models import BruteForce, NearestNeighbors
from frankenz_tpu_torch.ops import PDFDict
from frankenz_tpu_torch.samplers import (hierarchical_sampler,
                                         population_sampler)
from frankenz_tpu_torch.utils import network_from_jax
from test_torch_samplers import _feed_port, _scan_tables

MESH_TOL = dict(rtol=1e-5, atol=1e-7)      # test_parallel.py:237-244
KERNEL_TOL = dict(rtol=1e-3, atol=1e-5)    # test_parallel.py:241
GOF_TOL = dict(rtol=1e-5)
NET_TOL = dict(rtol=2e-3, atol=2e-5)
SUMMARY_TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def jmesh():
    assert jax.device_count() >= 8, "conftest should provide 8 CPU devices"
    return JPL.make_mesh(8)


@pytest.fixture(scope="module")
def tmesh():
    return PL.make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def one():
    return PL.make_mesh(devices=["cpu"])


@pytest.fixture(scope="module")
def problem():
    """tests/test_parallel.py's problem (float64)."""
    rng = np.random.default_rng(21)
    nobj, nmodel, nfilt = 64, 50, 5
    models = rng.uniform(1, 10, (nmodel, nfilt))
    data = rng.uniform(1, 10, (nobj, nfilt))
    return (data, np.full((nobj, nfilt), 0.3), np.ones_like(data), models,
            0.1 * models, np.ones_like(models))


def _G(nmodel, ngrid=64):
    rng = np.random.default_rng(5)
    return np.asarray(JK.kernel_matrix(rng.uniform(0, 3, nmodel),
                                       np.full(nmodel, 0.1),
                                       np.linspace(0, 3, ngrid)))


# ---------------------------------------------------------------------
# Meshes and containers
# ---------------------------------------------------------------------


def test_make_mesh_and_its_errors(monkeypatch):
    mesh = PL.make_mesh(devices=["cpu"] * 8)
    assert mesh.size == 8 and mesh.shape == (8,)
    assert mesh.axis_names == ("objects",)
    assert mesh.distinct_devices() == (torch.device("cpu"),)
    assert (mesh.process_index, mesh.process_count) == (0, 1)
    assert PL.make_mesh(4, devices=["cpu"] * 8).size == 4
    with pytest.raises(ValueError, match="requested 9 devices"):
        PL.make_mesh(9, devices=["cpu"] * 8)
    m2 = PL.make_mesh_2d(4, 2, devices=["cpu"] * 8)
    assert m2.shape == (4, 2) and m2.axis_names == ("objects", "models")
    with pytest.raises(ValueError, match="4x3=12"):
        PL.make_mesh_2d(4, 3, devices=["cpu"] * 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.make_mesh()
    with pytest.raises(TypeError, match="Mesh"):
        PL.check_mesh(object())


def test_shard_replicate_and_sharded(tmesh):
    x = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    s = PL.shard_objects(tmesh, x)
    assert len(s.shards) == 8 and s.shards[0].shape == (8, 3)
    assert s.is_fully_addressable and s.shape == (64, 3)
    np.testing.assert_array_equal(s.numpy(), x)
    np.testing.assert_array_equal(np.asarray(s), x)
    assert s.global_rows(3) == slice(24, 32)
    r = PL.replicate(tmesh, x)
    assert all(t is r.shards[0] for t in r.shards)  # one copy a device
    np.testing.assert_array_equal(r.numpy(), x)
    m2 = PL.make_mesh_2d(4, 2, devices=["cpu"] * 8)
    so, sm = PL.shard_objects(m2, x), PL.shard_models(m2, x)
    assert so.block_ids() == [0, 0, 1, 1, 2, 2, 3, 3]
    assert sm.block_ids() == [0, 1] * 4
    np.testing.assert_array_equal(so.numpy(), x)
    np.testing.assert_array_equal(sm.numpy(), x)
    with pytest.raises(ValueError, match="equal"):
        PL.shard_objects(tmesh, x[:63])


# ---------------------------------------------------------------------
# Sharded steps against JAX
# ---------------------------------------------------------------------


def test_sharded_logprob_matches_jax(problem, jmesh, tmesh):
    d, de, dm, m, me, mm = problem
    ds = JPL.shard_objects(jmesh, d, de, dm)
    mr = JPL.replicate(jmesh, m, me, mm)
    want = JPL.sharded_logprob(jmesh)(*ds, *mr)
    got = PL.sharded_logprob(tmesh)(d, de, dm, m, me, mm)
    assert isinstance(got.lnprob, PL.Sharded)
    assert len(got.lnprob.shards) == 8
    for field in ("lnprior", "lnlike", "lnprob", "chi2"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-12, err_msg=field)
    np.testing.assert_array_equal(got.ndim.numpy(), np.asarray(want.ndim))
    # Each shard is the single-device call on its rows.
    from frankenz_tpu_torch.ops import logprob

    single = logprob(*(torch.as_tensor(a) for a in problem))
    np.testing.assert_array_equal(got.lnprob.numpy(), single.lnprob.numpy())


@pytest.mark.parametrize("wt_thresh, cdf_thresh",
                         [(1e-3, 2e-4), (None, 2e-4), (None, None)])
def test_sharded_fit_predict_step_matches_jax(problem, jmesh, tmesh,
                                              wt_thresh, cdf_thresh):
    d, de, dm, m, me, mm = problem
    G = _G(m.shape[0])
    jstep = JPL.sharded_fit_predict_step(jmesh, wt_thresh=wt_thresh,
                                         cdf_thresh=cdf_thresh)
    want = jstep(*JPL.shard_objects(jmesh, d, de, dm),
                 *JPL.replicate(jmesh, m, me, mm, G))
    got = PL.sharded_fit_predict_step(tmesh, wt_thresh=wt_thresh,
                                      cdf_thresh=cdf_thresh)(
        d, de, dm, m, me, mm, G)
    for g, w in zip(got, want):
        assert isinstance(g, PL.Sharded) and len(g.shards) == 8
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8,
                                   atol=1e-12)


def test_model_sharded_step_matches_jax(problem):
    """4 x 2 mesh: objects over 4 rows, models over 2 columns."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    d, de, dm, m, me, mm = problem
    G = _G(m.shape[0])
    jm2 = JPL.make_mesh_2d(4, 2)
    ds = [jax.device_put(x, NamedSharding(jm2, P("objects")))
          for x in (d, de, dm)]
    ms = [jax.device_put(x, NamedSharding(jm2, P("models")))
          for x in (m, me, mm, G)]
    want = JPL.model_sharded_fit_predict_step(jm2)(*ds, *ms)
    tm2 = PL.make_mesh_2d(4, 2, devices=["cpu"] * 8)
    got = PL.model_sharded_fit_predict_step(tm2)(
        *PL.shard_objects(tm2, d, de, dm), *PL.shard_models(tm2, m, me, mm,
                                                            G))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-10)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-10)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-8, atol=1e-12)
    # Against the replicated-model composition (test_parallel.py:96-106).
    import frankenz_tpu.ops.likelihood as JL

    lnp = np.asarray(JL.logprob(d, de, dm, m, me, mm).lnprob)
    levid = np.asarray(jax.scipy.special.logsumexp(lnp, axis=1))
    wt = np.asarray(JK.threshold_weights(np.exp(lnp - levid[:, None]),
                                         1e-3, None))
    pdf = wt @ G
    np.testing.assert_allclose(got[0].numpy(),
                               pdf / pdf.sum(axis=1, keepdims=True),
                               rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("wt_thresh", [1e-3, None])
def test_ring_step_matches_jax(problem, jmesh, tmesh, wt_thresh):
    d, de, dm, m, me, mm = problem
    m, me, mm = m[:48], me[:48], mm[:48]
    G = _G(48)
    step = JPL.ring_fit_predict_step(jmesh, wt_thresh=wt_thresh)
    want = step(*JPL.shard_objects(jmesh, d, de, dm),
                *JPL.shard_objects(jmesh, m, me, mm, G))
    got = PL.ring_fit_predict_step(tmesh, wt_thresh=wt_thresh)(
        d, de, dm, m, me, mm, G)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-10)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-10)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-8, atol=1e-12)
    assert len(got[0].shards) == 8


@pytest.mark.parametrize("wt_thresh", [1e-3, None])
def test_ring_step_all_masked_object_returns_neg_inf(problem, tmesh,
                                                     wt_thresh):
    d, de, dm, m, me, mm = problem
    dm = dm.copy()
    dm[3] = 0.0
    G = _G(48)
    pdf, lmap, levid = (x.numpy() for x in PL.ring_fit_predict_step(
        tmesh, wt_thresh=wt_thresh)(d, de, dm, m[:48], me[:48], mm[:48], G))
    assert lmap[3] == -np.inf and levid[3] == -np.inf
    np.testing.assert_array_equal(pdf[3], 0.0)
    assert np.isfinite(lmap[[0, 1, 2]]).all()


def test_stacked_nz_matches_jax(jmesh, tmesh):
    rng = np.random.default_rng(3)
    pdfs = rng.uniform(size=(64, 33))
    pdfs /= pdfs.sum(axis=1, keepdims=True)
    want = np.asarray(JPL.stacked_nz(jmesh,
                                     JPL.shard_objects(jmesh, pdfs)))
    got = PL.stacked_nz(tmesh, PL.shard_objects(tmesh, pdfs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(got, pdfs.sum(axis=0), rtol=1e-10)


def test_catalog_io_matches_jax(jmesh, tmesh):
    for pc in (1, 3, 4, 8):
        for pi in range(pc):
            assert (PL.process_shard_bounds(103, pi, pc)
                    == JPL.process_shard_bounds(103, pi, pc))
    assert PL.process_shard_bounds(103) == (0, 103)
    rng = np.random.default_rng(0)
    cat = {"phot": rng.uniform(1, 10, (64, 5)), "z": rng.uniform(0, 3, 64)}
    fast = PL.catalog_from_process_shards(tmesh, cat, 64)
    assembled = PL.catalog_from_process_shards(tmesh, cat, 64,
                                               process_count=1)
    want = JPL.catalog_from_process_shards(jmesh, cat, 64, process_count=1)
    for k in cat:
        assert isinstance(assembled[k], PL.Sharded)
        assert len(assembled[k].shards) == 8
        np.testing.assert_array_equal(assembled[k].numpy(), fast[k].numpy())
        np.testing.assert_array_equal(assembled[k].numpy(),
                                      np.asarray(want[k]))
    with pytest.raises(ValueError, match="equal blocks"):
        PL.catalog_from_process_shards(tmesh, {"x": cat["z"][:30]}, 64,
                                       process_count=2)
    # Batches cover every row once, ragged tail included, from Sharded
    # arrays and host arrays alike.
    for src in (fast, cat):
        seen, starts = [], []
        for start, n, batch in PL.catalog_batches(src, 24):
            assert batch["phot"].shape[0] == n == batch["z"].shape[0]
            seen.append(np.asarray(batch["phot"]))
            starts.append(start)
        assert starts == [s for s, _, _ in JPL.catalog_batches(want, 24)]
        np.testing.assert_array_equal(np.concatenate(seen), cat["phot"])


# ---------------------------------------------------------------------
# mesh= in the fitters
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf_problem():
    """tests/test_parallel.py:202-216 (float32), plus a 15%-masked copy
    and 53 objects, which neither the batch nor the mesh divides."""
    rng = np.random.default_rng(21)
    M, B, F = 200, 53, 5
    m = rng.uniform(1, 10, (M, F)).astype(np.float32)
    me = (0.05 * m).astype(np.float32)
    d = (m[rng.integers(0, M, B)] + rng.normal(0, 0.3, (B, F))).astype(
        np.float32)
    de = np.full((B, F), 0.3, np.float32)
    dm = np.ones_like(d)
    masked = dm.copy()
    masked[rng.uniform(size=masked.shape) < 0.15] = 0.0
    return dict(models=(m, me, np.ones_like(m)), data=(d, de),
                masks={"full": dm, "masked": masked},
                zlab=rng.uniform(0, 3, M), zerr=np.full(M, 0.1),
                grid=np.linspace(0, 3, 101))


@pytest.mark.parametrize("mask", ["full", "masked"])
@pytest.mark.parametrize("route", ["fused", "onepass", "cdf", "plain"])
def test_bruteforce_mesh_matches_single_device_and_jax(bf_problem, jmesh,
                                                       tmesh, one, mask,
                                                       route):
    p = bf_problem
    args = p["data"] + (p["masks"][mask], p["zlab"], p["zerr"])
    kw = dict(label_grid=p["grid"], verbose=False, return_gof=True,
              batch_size=32)
    kw.update({"fused": {}, "onepass": dict(wt_thresh=None,
                                            cdf_thresh=None),
               "cdf": dict(wt_thresh=None),
               "plain": dict(use_fused=False)}[route])
    tbf = BruteForce(*p["models"], device="cpu")
    single = tbf.fit_predict(*args, **kw)
    sharded = tbf.fit_predict(*args, mesh=tmesh, **kw)
    np.testing.assert_allclose(sharded[0], single[0], **MESH_TOL)
    np.testing.assert_allclose(sharded[1][0], single[1][0], **GOF_TOL)
    np.testing.assert_allclose(sharded[1][1], single[1][1], **GOF_TOL)
    if route != "cdf":  # the cdf mode's mesh route is the composition
        lone = tbf.fit_predict(*args, mesh=one, **kw)
        for g, w in zip((lone[0],) + lone[1], (single[0],) + single[1]):
            np.testing.assert_array_equal(g, w)
    jkw = dict(kw, use_fused=False)
    want = JaxBruteForce(*p["models"]).fit_predict(*args, mesh=jmesh,
                                                   **jkw)
    tol = KERNEL_TOL if route in ("fused", "onepass") else MESH_TOL
    np.testing.assert_allclose(sharded[0], want[0], **tol)
    np.testing.assert_allclose(sharded[1][0], want[1][0], **GOF_TOL)
    np.testing.assert_allclose(sharded[1][1], want[1][1], **GOF_TOL)


def test_bruteforce_mesh_fit_summarize(bf_problem, jmesh, tmesh, one):
    p = bf_problem
    args = p["data"] + (p["masks"]["full"], p["zlab"], p["zerr"])
    kw = dict(label_grid=p["grid"], verbose=False, batch_size=32)
    tbf = BruteForce(*p["models"], device="cpu")
    single, gof = tbf.fit_summarize(*args, **kw)
    sharded, gof_s = tbf.fit_summarize(*args, mesh=tmesh, **kw)
    lone, _ = tbf.fit_summarize(*args, mesh=one, **kw)
    cols = np.asarray(JS._pack_summary(sharded))
    np.testing.assert_allclose(cols, np.asarray(JS._pack_summary(single)),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(np.asarray(JS._pack_summary(lone)),
                                  np.asarray(JS._pack_summary(single)))
    np.testing.assert_allclose(gof_s[1], gof[1], **GOF_TOL)
    want, _ = JaxBruteForce(*p["models"]).fit_summarize(
        *args, mesh=jmesh, use_fused=False, **kw)
    np.testing.assert_allclose(cols, np.asarray(JS._pack_summary(want)),
                               **SUMMARY_TOL)


def test_bruteforce_mesh_errors(bf_problem, tmesh):
    """The JAX fitter's refusals under mesh= (bruteforce.py:589-602)."""
    p = bf_problem
    args = p["data"] + (p["masks"]["full"], p["zlab"], p["zerr"])
    kw = dict(label_grid=p["grid"], verbose=False)
    tbf = BruteForce(*p["models"], device="cpu")
    for bad in (dict(save_fits=True), dict(track_scale=True)):
        with pytest.raises(ValueError, match="mesh"):
            tbf.fit_predict(*args, mesh=tmesh, **bad, **kw)
    with pytest.raises(ValueError, match="cdf_thresh selection"):
        tbf.fit_predict(*args, mesh=tmesh, use_fused=True, wt_thresh=None,
                        **kw)
    with pytest.raises(TypeError, match="Mesh"):
        tbf.fit_predict(*args, mesh=JPL.make_mesh(8), **kw)


@pytest.fixture(scope="module")
def knn_problem():
    """tests/test_parallel.py:272-285."""
    rng = np.random.default_rng(33)
    M, B, F = 400, 64, 4
    m = rng.uniform(1, 10, (M, F)).astype(np.float32)
    me = (0.05 * m).astype(np.float32)
    d = (m[rng.integers(0, M, B)] + rng.normal(0, 0.3, (B, F))).astype(
        np.float32)
    return dict(models=(m, me, np.ones_like(m)),
                args=(d, np.full((B, F), 0.3, np.float32), np.ones_like(d),
                      rng.uniform(0, 3, M), np.full(M, 0.1)),
                grid=np.linspace(0, 3, 101))


@pytest.mark.parametrize("labels", ["grid", "dict"])
def test_knn_mesh_matches_single_device_and_jax(knn_problem, jmesh, tmesh,
                                                one, labels):
    p = knn_problem
    grid = p["grid"]
    sig = np.linspace(0.01, 0.3, 20)
    lab_t = ({"label_grid": grid} if labels == "grid"
             else {"label_dict": PDFDict(grid, sig)})
    lab_j = ({"label_grid": grid} if labels == "grid"
             else {"label_dict": JaxPDFDict(grid, sig)})
    kw = dict(k=8, verbose=False, batch_size=32, return_gof=True)
    nn = NearestNeighbors(*p["models"], K=5, seed=3, verbose=False,
                          device="cpu")

    def run(**extra):
        return nn.fit_predict(*p["args"], rng=np.random.default_rng(7),
                              **kw, **lab_t, **extra)

    single, sharded, lone = run(), run(mesh=tmesh), run(mesh=one)
    np.testing.assert_allclose(sharded[0], single[0], **MESH_TOL)
    np.testing.assert_allclose(sharded[1][1], single[1][1], **GOF_TOL)
    np.testing.assert_array_equal(lone[0], single[0])
    np.testing.assert_array_equal(lone[1][1], single[1][1])
    jnn = JaxNN(*p["models"], K=5, seed=3, verbose=False)
    want = jnn.fit_predict(*p["args"], rng=np.random.default_rng(7),
                           mesh=jmesh, **kw, **lab_j)
    np.testing.assert_allclose(sharded[0], want[0], **MESH_TOL)
    np.testing.assert_allclose(sharded[1][1], want[1][1], **GOF_TOL)
    with pytest.raises(ValueError, match="save_fits"):
        run(mesh=tmesh, save_fits=True)


@pytest.fixture(scope="module")
def som_pair():
    """tests/test_parallel.py:305-325: a JAX-trained, populated SOM and
    the port's copy of it."""
    rng = np.random.default_rng(44)
    M, B = 300, 48
    centers = np.array([[2.0, 5.0, 8.0], [8.0, 3.0, 2.0], [5.0, 9.0, 4.0]])
    zc = np.array([0.4, 1.2, 2.2])
    models = np.vstack([c + rng.normal(0, 0.3, (100, 3)) for c in centers])
    zlab = np.concatenate([z + rng.normal(0, 0.05, 100) for z in zc])
    me = np.full_like(models, 0.05)
    d = models[rng.integers(0, M, B)] + rng.normal(0, 0.1, (B, 3))
    som = JaxSOM(models, me, np.ones_like(models))
    som.train_network(nside=3, nproj=2, niter=40, nbatch=10, seed=2,
                      verbose=False)
    som.populate_network(verbose=False, batch_size=64)
    args = (d, np.full_like(d, 0.1), np.ones_like(d), zlab,
            np.full(M, 0.05))
    return som, network_from_jax(som, "cpu"), args


@pytest.mark.parametrize("nodes_only", [True, False])
def test_network_mesh_matches_single_device_and_jax(som_pair, jmesh, tmesh,
                                                    one, nodes_only):
    jsom, tsom, args = som_pair
    kw = dict(label_grid=np.linspace(0, 3, 101), nodes_only=nodes_only,
              verbose=False, batch_size=16, max_neighbors=256,
              save_fits=False, return_gof=True)
    single = tsom.fit_predict(*args, **kw)
    sharded = tsom.fit_predict(*args, mesh=tmesh, **kw)
    lone = tsom.fit_predict(*args, mesh=one, **kw)
    np.testing.assert_allclose(sharded[0], single[0], **MESH_TOL)
    np.testing.assert_allclose(sharded[1][0], single[1][0], **GOF_TOL)
    np.testing.assert_allclose(sharded[1][1], single[1][1], **GOF_TOL)
    for g, w in zip((lone[0],) + lone[1], (single[0],) + single[1]):
        np.testing.assert_array_equal(g, w)
    want = jsom.fit_predict(*args, mesh=jmesh, **kw)
    np.testing.assert_allclose(sharded[0], want[0], **NET_TOL)
    np.testing.assert_allclose(sharded[1][1], want[1][1], **GOF_TOL)
    with pytest.raises(ValueError, match="save_fits"):
        tsom.fit_predict(*args, mesh=tmesh, **dict(kw, save_fits=True))


# ---------------------------------------------------------------------
# mesh= in the samplers
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def pop_pdfs():
    """tests/test_parallel.py:353-357: 203 objects, not a multiple of 8."""
    rng = np.random.default_rng(9)
    pdfs = rng.uniform(0.05, 1.0, (203, 12))
    return pdfs / pdfs.sum(axis=1, keepdims=True)


def test_population_mesh_matches_jax_sharded_run(pop_pdfs, jmesh, tmesh,
                                                 monkeypatch):
    """The port's sharded step loop against JAX's `_pop_run_sharded`, on
    the draws JAX's scan makes from its keys (the pattern of
    tests/test_torch_samplers.py:401-432), float64, with padded rows."""
    niter, thin, mh, nchains, seed = 5, 20, 3, 2, 4
    kw = dict(thin=thin, mh_steps=mh, seed=seed, nchains=nchains,
              verbose=False)
    jsamp = JaxPop(pop_pdfs)
    jsamp.run_mcmc(niter, mesh=jmesh, **kw)
    tables = _scan_tables(seed, nchains, niter, thin, 12, mh)
    _feed_port(monkeypatch, list(tables))
    ours = population_sampler(pop_pdfs, device="cpu", dtype=torch.float64)
    ours.run_mcmc(niter, mesh=tmesh, **kw)
    got, got_lnp = ours.results
    want, want_lnp = jsamp.results
    np.testing.assert_allclose(got, np.asarray(want), **MESH_TOL)
    np.testing.assert_allclose(got_lnp, np.asarray(want_lnp), rtol=1e-6)
    # The stored lnpost is the unpadded catalog's.
    np.testing.assert_allclose(
        got_lnp[-1], np.sum(np.log(pop_pdfs @ got[-1])), rtol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_population_mesh_matches_single_device(pop_pdfs, tmesh, one,
                                               dtype):
    kw = dict(thin=20, seed=4, verbose=False)
    runs = {}
    for name, extra in (("single", dict(use_kernel=False)),
                        ("mesh", dict(mesh=tmesh)), ("one", dict(mesh=one))):
        s = population_sampler(pop_pdfs, device="cpu", dtype=dtype)
        s.run_mcmc(5, **kw, **extra)
        runs[name] = s.results
    # In float32 the shards' partial log-sums, added in another order
    # than one device's sum, move the chain by ~1e-5 over its 100 steps
    # (no accept flips); float64 holds test_parallel.py:373-376.
    tol = (MESH_TOL if dtype == torch.float64
           else dict(rtol=0, atol=3e-5))
    np.testing.assert_allclose(runs["mesh"][0], runs["single"][0], **tol)
    np.testing.assert_allclose(runs["mesh"][1], runs["single"][1],
                               rtol=1e-6)
    for g, w in zip(runs["one"], runs["single"]):
        np.testing.assert_array_equal(g, w)
    # A streamed mesh run is the stored one.
    streamed = list(population_sampler(pop_pdfs, device="cpu",
                                       dtype=dtype).sample(
        5, thin=20, seed=4, mesh=tmesh, block=2))
    np.testing.assert_array_equal(np.array([x[0] for x in streamed]),
                                  runs["mesh"][0])
    np.testing.assert_array_equal(np.array([x[1] for x in streamed]),
                                  runs["mesh"][1])
    samp = population_sampler(pop_pdfs, device="cpu")
    with pytest.raises(ValueError, match="kernel route"):
        samp.run_mcmc(2, mesh=tmesh, use_kernel=True, verbose=False)


def _hier_problem(nobs=403, nbins=20):
    """tests/test_parallel.py:382-392."""
    rng = np.random.default_rng(3)
    grid = np.arange(nbins)
    nz_true = np.exp(-0.5 * ((grid - 7.0) / 2.5) ** 2)
    nz_true /= nz_true.sum()
    ztrue = rng.choice(nbins, size=nobs, p=nz_true)
    centers = ztrue + rng.normal(0, 0.8, nobs)
    pdfs = np.exp(-0.5 * ((grid[None, :] - centers[:, None]) / 0.8) ** 2)
    return grid, ztrue, pdfs / pdfs.sum(axis=1, keepdims=True)


def test_hierarchical_mesh_recovers_truth_as_jax(tmesh, jmesh, one):
    """The recovery criteria of tests/test_parallel.py:380-412 on the
    port and on JAX, a padded object count, and a one-shard mesh equal to
    the single-device chain."""
    grid, ztrue, pdfs = _hier_problem()
    emp = np.bincount(ztrue, minlength=len(grid)) / len(ztrue)
    for samp, mesh in ((hierarchical_sampler(pdfs, device="cpu"), tmesh),
                       (JaxHier(pdfs), jmesh)):
        samp.run_mcmc(60, thin=5, seed=4, verbose=False, mesh=mesh)
        samples, lnps = samp.results
        assert samples.shape == (60, len(grid))
        np.testing.assert_allclose(samples.sum(axis=1), 1.0, atol=1e-3)
        assert np.isfinite(lnps).all()
        post = samples[20:].mean(axis=0)
        assert abs(post @ grid - emp @ grid) < 0.3
        assert np.abs(post - emp).sum() < 0.4
    a = hierarchical_sampler(pdfs, device="cpu")
    a.run_mcmc(8, thin=3, seed=4, verbose=False, nchains=2)
    b = hierarchical_sampler(pdfs, device="cpu")
    b.run_mcmc(8, thin=3, seed=4, verbose=False, nchains=2, mesh=one)
    for g, w in zip(b.results, a.results):
        np.testing.assert_array_equal(g, w)
    # The streamed mesh chain is the stored one.
    c = hierarchical_sampler(pdfs, device="cpu")
    c.run_mcmc(6, thin=3, seed=4, verbose=False, mesh=tmesh,
               ref_sample=np.full(len(grid), 5.0))
    streamed = list(hierarchical_sampler(pdfs, device="cpu").sample(
        6, thin=3, seed=4, mesh=tmesh, block=4,
        ref_sample=np.full(len(grid), 5.0)))
    np.testing.assert_array_equal(np.array([x[0] for x in streamed]),
                                  c.results[0])
