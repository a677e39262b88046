"""Port parity: the cdf mode's one walk over the models,
`lnl_reduce_topk` (lmap, levid and the top-T table), against the JAX
package on the CPU.

JAX runs the cdf mode's reduce and top-T as two Pallas kernels over the
same lnl tiles (`_make_reduce_kernel`, frankenz_tpu/ops/fused.py:599, and
`_make_topk_kernel`, :721; pallas_calls :1903 and :1920); here they run
in interpret mode with the glue's tiles (tb=8, tm=128) and padding
(:2135-2156), as the JAX package's own tests run its kernels on the CPU.
The port's wrapper on CPU tensors runs its plain version, `lnl_reduce_plain`
and `lnl_topk_plain` over one lnl grid, which must equal the two plain
versions bit for bit.  Tolerances: lmap, levid and the top-T values
tests/test_fused.py's rtol 2e-5, atol 1e-5 (float32 roundoff of the lnl
chain in another order; free scale with model errors 1e-3, its JAX
tolerance, tests/test_fused.py:182-187); tie counts exact (duplicate
models tie bit for bit on both sides).  The cdf `fit_predict` /
`fit_summarize` of the port's BruteForce are held against the JAX
fitter's at tests/test_fused.py:114-119 (lmap / levid rtol 2e-5, atol
2e-5; PDFs rtol 2e-3, atol 2e-5) and tests/test_torch_general.py's
summary tolerances, and the cdf route calls `lnl_reduce_topk` once per
batch and neither `lnl_reduce` nor `lnl_topk`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from _torch_port import to_numpy
from frankenz_tpu.models import BruteForce as JaxBruteForce
from frankenz_tpu.ops import fused as JF
from frankenz_tpu.ops import kde as JK
from frankenz_tpu.ops import summarize as JS
from frankenz_tpu_torch.kernels import general as GK
from frankenz_tpu_torch.ops import fused as TF
from frankenz_tpu_torch.utils import from_jax_bruteforce

GOF_TOL = dict(rtol=2e-5, atol=1e-5)
ME_TOL = dict(rtol=1e-3, atol=1e-3)
TB, TM = 8, 128
CDF = dict(wt_thresh=None, cdf_thresh=2e-4)
FLAGS = {
    "fixed": dict(),
    "free": dict(free_scale=True, ignore_model_err=True),
    "free_me": dict(free_scale=True),
}


def _problem(B=19, M=300, F=5, masked=True, seed=17, dup=True):
    """tests/test_fused.py's generator, ragged against both tiles (B=19,
    M=300), models 60-119 duplicating 0-59 and the data drawn near them
    (their lnl ties; one 128-model convergence group under free scale
    with model errors, so the ties are exact there too); masked: 10% of
    data and model bands missing, the first two kept.  ``dup=False``
    leaves the models distinct: JAX drops a tie group that straddles the
    cdf cut whole, the port only the reference's share
    (tests/test_torch_general.py), so PDFs are compared without ties."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(1, 10, (M, F)).astype(np.float32)
    if dup:
        m[60:120] = m[:60]
    me = (0.05 * m).astype(np.float32)
    mm = np.ones((M, F), np.float32)
    dm = np.ones((B, F), np.float32)
    if masked:
        mm = (rng.uniform(size=(M, F)) > 0.1).astype(np.float32)
        mm[:, :2] = 1.0
        if dup:
            mm[60:120] = mm[:60]
        dm = (rng.uniform(size=(B, F)) > 0.1).astype(np.float32)
        dm[:, :2] = 1.0
    d = (m[rng.integers(0, 60, B)]
         + rng.normal(0, 0.3, (B, F))).astype(np.float32)
    de = np.full((B, F), 0.3, np.float32)
    return d, de, dm, m, me, mm


def _jax_reduce_topk(d, de, dm, m, me, mm, *, T, full_mask, dim_prior=True,
                     ignore_model_err=False, free_scale=False,
                     scale_ltol=1e-4, scale_max_iter=100):
    """JAX's reduce and top-T pallas_calls (ops/fused.py:1900-1930) in
    interpret mode: (lmap, levid, vals, cnts) as numpy arrays."""
    B, F = d.shape
    M = m.shape[0]
    Bp, Mp = -(-B // TB) * TB, -(-M // TM) * TM

    def pad(x, n, value):
        return jnp.pad(jnp.asarray(x, jnp.float32), ((0, n), (0, 0)),
                       constant_values=value)

    d_, de_, dm_ = pad(d, Bp - B, 0.0), pad(de, Bp - B, 1.0), \
        pad(dm, Bp - B, 0.0)
    mT, meT, mmT = (pad(x, Mp - M, v).T for x, v in
                    ((m, 1e15), (me, 1.0), (mm, 0.0)))
    valid = jnp.pad(jnp.ones((1, M), jnp.float32), ((0, 0), (0, Mp - M)))
    gl_table = tuple(float(JF._sp_gammaln(0.5 * k) + JF._LOG_2 * 0.5 * k)
                     if k > 0 else float("inf") for k in range(F + 1))
    args = (F, dim_prior, ignore_model_err, gl_table, full_mask, free_scale,
            scale_ltol, scale_max_iter)
    data_spec = pl.BlockSpec((TB, F), lambda i, j: (i, 0))
    model_spec = pl.BlockSpec((F, TM), lambda i, j: (0, j))
    in_specs = [data_spec] * 3 + [model_spec] * 3 + [
        pl.BlockSpec((1, TM), lambda i, j: (0, j))]

    def call(kernel, width):
        spec = pl.BlockSpec((TB, width), lambda i, j: (i, 0))
        shape = jax.ShapeDtypeStruct((Bp, width), jnp.float32)
        return pl.pallas_call(kernel, grid=(Bp // TB, Mp // TM),
                              in_specs=in_specs, out_specs=(spec, spec),
                              out_shape=(shape, shape), interpret=True)(
            d_, de_, dm_, mT, meT, mmT, valid)

    lmap, levid = call(JF._make_reduce_kernel(*args), 1)
    vals, cnts = call(JF._make_topk_kernel(*args, T), T)
    return tuple(np.asarray(x)[:B] for x in (lmap[:, 0], levid[:, 0], vals,
                                             cnts))


def _port_flags(t, flags, full_mask):
    """The wrapper's flags; with model errors, the sweep table over
    JAX's 128-model tiles."""
    out = dict(flags, full_mask=full_mask)
    if out.get("free_scale") and not out.get("ignore_model_err"):
        out.update(tm=TM, sweeps=GK.scale_sweeps(*t, tm=TM,
                                                 full_mask=full_mask))
    return out


def _tensors(prob):
    d, de, dm, m, me, mm = prob
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in (d, de, dm, m.T, me.T, mm.T)]


@pytest.mark.parametrize("T", [1, 2, 8])
@pytest.mark.parametrize("dim_prior", [True, False])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("scale", sorted(FLAGS))
def test_reduce_topk_matches_jax_kernels(scale, masked, dim_prior, T):
    prob = _problem(masked=masked)
    t = _tensors(prob)
    flags = _port_flags(t, dict(FLAGS[scale], dim_prior=dim_prior),
                        not masked)
    got = [x.numpy() for x in GK.lnl_reduce_topk(*t, T=T, **flags)]
    want = _jax_reduce_topk(*prob, T=T, full_mask=not masked,
                            **{k: v for k, v in flags.items()
                               if k not in ("sweeps", "tm", "full_mask")})
    tol = ME_TOL if scale == "free_me" else GOF_TOL
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, **tol)
    np.testing.assert_array_equal(got[3], want[3])
    if T > 1:
        assert got[3].max() >= 2.0  # the duplicate models tied


@pytest.mark.parametrize("B,M", [(19, 300), (1, 64), (40, 65), (33, 129)])
@pytest.mark.parametrize("T", [1, 2, 8, 40])
@pytest.mark.parametrize("scale", sorted(FLAGS))
def test_reduce_topk_plain_is_reduce_and_topk_bit_for_bit(scale, T, B, M):
    """The plain version is `lnl_reduce_plain` and `lnl_topk_plain`, bit
    for bit, for any T (more slots than distinct values leave float32
    min / 0 slots); the wrapper on CPU tensors runs it and launches
    nothing."""
    prob = _problem(B=B, M=max(M, 300))
    prob = prob[:3] + tuple(x[:M] for x in prob[3:])
    t = _tensors(prob)
    flags = _port_flags(t, FLAGS[scale], False)
    GK.reset_launch_counts()
    got = GK.lnl_reduce_topk(*t, T=T, **flags)
    want = (*GK.lnl_reduce_plain(*t, **flags),
            *GK.lnl_topk_plain(*t, T=T, **flags))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2].shape == (B, T)
    assert all(n == 0 for n in GK.launch_counts().values())


def _spy(monkeypatch, names):
    calls = {n: 0 for n in names}
    for n in names:
        orig = getattr(GK, n)

        def spy(*a, _orig=orig, _n=n, **k):
            calls[_n] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(GK, n, spy)
    return calls


@pytest.mark.parametrize("scale", sorted(FLAGS))
def test_cdf_route_walks_the_models_twice(scale, monkeypatch):
    """A cdf call runs `lnl_reduce_topk` and the band stack, once each,
    and neither `lnl_reduce` nor `lnl_topk`; its outputs match JAX's
    fused cdf route."""
    prob = _problem(B=24, masked=True, dup=False)
    G = np.asarray(JK.kernel_matrix(
        np.random.default_rng(3).uniform(0, 3, 300), np.full(300, 0.1),
        np.linspace(0, 3, 101)), np.float32)
    kw = dict(FLAGS[scale], **CDF)
    calls = _spy(monkeypatch, ("lnl_reduce", "lnl_topk", "lnl_reduce_topk",
                               "lnl_cut_stack", "scale_sweeps"))
    got = to_numpy(TF.fused_fit_pdf(*prob, G, tm=TM, **kw))
    assert calls == {"lnl_reduce": 0, "lnl_topk": 0, "lnl_reduce_topk": 1,
                     "lnl_cut_stack": 1,
                     "scale_sweeps": int(scale == "free_me")}
    want = to_numpy(JF.fused_fit_pdf(*prob, G, tb=TB, tm=TM, interpret=True,
                                     screen=False, band_skip=False, **kw))
    tol = ME_TOL if scale == "free_me" else GOF_TOL
    np.testing.assert_allclose(got[1], want[1], **tol)
    np.testing.assert_allclose(got[2], want[2], **tol)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-3,
                               atol=1e-4 if scale == "free_me" else 2e-5)


@pytest.fixture(scope="module")
def cdf_fit():
    rng = np.random.default_rng(11)
    B, M, F, Ngrid = 160, 700, 5, 101
    f32 = np.float32
    models = rng.uniform(1, 10, (M, F)).astype(f32)
    mmask = (rng.uniform(size=(M, F)) > 0.1).astype(f32)
    data = (models[rng.integers(0, M, B)]
            + rng.normal(0, 0.25, (B, F))).astype(f32)
    dmask = (rng.uniform(size=(B, F)) > 0.15).astype(f32)
    p = dict(args=(data, np.full((B, F), 0.25, f32), dmask,
                   rng.uniform(0, 3, M), np.full(M, 0.1)),
             grid=np.linspace(0, 3, Ngrid))
    p["jax"] = JaxBruteForce(models, (0.05 * models).astype(f32), mmask)
    p["torch"] = from_jax_bruteforce(p["jax"], device="cpu")
    return p


def test_cdf_fit_predict_matches_jax(cdf_fit, monkeypatch):
    """BruteForce's cdf mode in 64-object batches: one `lnl_reduce_topk`
    a batch, no rerun, JAX's fused fitter's outputs at
    tests/test_fused.py:114-119."""
    p = cdf_fit
    kw = dict(label_grid=p["grid"], verbose=False, return_gof=True, **CDF)
    calls = _spy(monkeypatch, ("lnl_reduce", "lnl_topk", "lnl_reduce_topk"))
    bf = p["torch"]
    got = bf.fit_predict(*p["args"], batch_size=64, **kw)
    assert bf.cdf_reruns == 0
    assert calls == {"lnl_reduce": 0, "lnl_topk": 0, "lnl_reduce_topk": 3}
    want = p["jax"].fit_predict(*p["args"], use_fused=True, **kw)
    for k in (0, 1):
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=2e-5,
                                   atol=2e-5)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-3, atol=2e-5)


def test_cdf_fit_summarize_matches_jax_and_own_pdfs(cdf_fit):
    """The 21 summary columns of the cdf mode: JAX's fused fitter's at
    tests/test_torch_general.py's summary tolerances, and the port's own
    `pdfs_summarize(fit_predict)` at 2e-5 / 2e-6."""
    from frankenz_tpu_torch.ops import pdfs_summarize
    from frankenz_tpu_torch.ops import summarize as TS

    p = cdf_fit
    kw = dict(label_grid=p["grid"], verbose=False, **CDF)
    got, gof = p["torch"].fit_summarize(*p["args"], **kw)
    want, gof_j = p["jax"].fit_summarize(*p["args"], use_fused=True, **kw)
    cols = np.asarray(JS._pack_summary(got))
    np.testing.assert_allclose(cols, np.asarray(JS._pack_summary(want)),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(gof[0], gof_j[0], rtol=2e-5, atol=2e-5)
    pdfs = p["torch"].fit_predict(*p["args"], return_gof=True, **kw)[0]
    u = np.random.default_rng(0).random(len(pdfs))
    own = pdfs_summarize(torch.from_numpy(pdfs), p["grid"], u=u)
    np.testing.assert_allclose(cols, to_numpy(TS._pack_summary(own)),
                               rtol=2e-5, atol=2e-6)
