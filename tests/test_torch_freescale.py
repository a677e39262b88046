"""Port parity: the free-scale likelihood and its kernels' plain versions,
against the JAX package on the CPU.

* Plain `loglike_free` (both branches: the matmul one for datum-only
  variance and 8+ objects, the fixed point otherwise) against
  `frankenz_tpu.ops.likelihood.loglike_free` in float64 at rtol 1e-6, and
  against the NumPy oracle (tests/_oracle.py) at the same tolerance.
* `fused_fit_pdf(free_scale=True)` against JAX's fused route
  (`interpret=True, tb=8, tm=128`; the port's `tm` matches), with JAX's
  own tolerances (tests/test_fused.py): without model errors lmap /
  levid 1e-4 and PDFs rtol 5e-3 / atol 5e-5 (:145-150), with them 1e-3
  and rtol 3e-3 / atol 1e-4 (:182-187).  JAX's interpret-mode
  reciprocal is not a true divide, so a sweep count may differ by one;
  these envelopes cover it.
* `scale_sweeps_plain`'s table against the sweeps JAX's own tile
  (`_lnl_tile_freescale_me`) runs, group by group, with the models of a
  ragged last group padded by JAX's sentinels, both with IEEE divides:
  equal.
* BruteForce: `fit(track_scale=True)`, free-scale `fit_predict`, the
  `ltol` / `max_iter` keywords reaching the kernels, `track_scale` on
  the plain path, and the saved fits carried across from JAX.

The grids are 101 points wide: JAX band-sorts the models above 128
(ops/fused.py:1863-1872), which regroups the free-scale convergence
groups (ROADMAP section 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _oracle as oracle
from _torch_port import to_numpy
from frankenz_tpu.models import BruteForce as JaxBruteForce
from frankenz_tpu.ops import fused as JF
from frankenz_tpu.ops import kde as JK
from frankenz_tpu.ops import likelihood as JL
from frankenz_tpu_torch.kernels import general as GK
from frankenz_tpu_torch.models import bruteforce as TBF
from frankenz_tpu_torch.ops import fused as TF
from frankenz_tpu_torch.ops import likelihood as TL
from frankenz_tpu_torch.utils import from_jax_bruteforce

IME_TOL = dict(gof=dict(rtol=1e-4, atol=1e-4), pdf=dict(rtol=5e-3, atol=5e-5))
ME_TOL = dict(gof=dict(rtol=1e-3, atol=1e-3), pdf=dict(rtol=3e-3, atol=1e-4))
THRESHOLDS = {"wt_thresh": dict(wt_thresh=1e-3),
              "cdf": dict(wt_thresh=None, cdf_thresh=2e-4)}


def _scaled_problem(B=16, M=300, F=5, Ngrid=101, seed=17):
    """tests/test_fused.py's `problem`, the data scaled copies of models
    (so the scale iterates), 10% of data and model bands masked."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(1, 10, (M, F)).astype(np.float32)
    me = (0.05 * m).astype(np.float32)
    mm = (rng.uniform(size=(M, F)) > 0.1).astype(np.float32)
    mm[:, :2] = 1.0
    d = (rng.uniform(0.5, 2.0, (B, 1)) * m[rng.integers(0, M, B)]
         + rng.normal(0, 0.3, (B, F))).astype(np.float32)
    de = np.full((B, F), 0.3, np.float32)
    dm = (rng.uniform(size=(B, F)) > 0.1).astype(np.float32)
    dm[:, :2] = 1.0
    G = np.asarray(JK.kernel_matrix(
        rng.uniform(0, 3, M), np.full(M, 0.1), np.linspace(0, 3, Ngrid)),
        np.float32)
    return d, de, dm, m, me, mm, G


@pytest.fixture(scope="module")
def problem():
    return _scaled_problem()


def _full(prob):
    d, de, dm, m, me, mm, G = prob
    return d, de, np.ones_like(dm), m, me, np.ones_like(mm), G


def _assert_close(got, want, tol):
    assert got[0].shape == want[0].shape and got[0].dtype == np.float32
    np.testing.assert_allclose(got[1], want[1], **tol["gof"])
    np.testing.assert_allclose(got[2], want[2], **tol["gof"])
    np.testing.assert_allclose(got[0], want[0], **tol["pdf"])


def fused_pair(prob, **kw):
    """(port, JAX) outputs of `fused_fit_pdf` on one problem."""
    got = to_numpy(TF.fused_fit_pdf(*prob, tm=128, **kw))
    want = to_numpy(JF.fused_fit_pdf(*prob, tb=8, tm=128, interpret=True,
                                     scale_ltol=1e-4, **kw))
    return got, want


# ---------------------------------------------------------------------
# The plain likelihood.
# ---------------------------------------------------------------------


def _likelihood_problem(nobj, masked, seed=0):
    rng = np.random.default_rng(seed)
    M, F = 300, 5
    m = rng.uniform(1, 10, (M, F))
    me = 0.05 * m
    d = (rng.uniform(0.5, 2.0, (nobj, 1)) * m[rng.integers(0, M, nobj)]
         + rng.normal(0, 0.3, (nobj, F)))
    de = np.full((nobj, F), 0.3)
    dm, mm = np.ones((nobj, F)), np.ones((M, F))
    if masked:
        dm = (rng.uniform(size=(nobj, F)) > 0.2) * 1.0
        mm = (rng.uniform(size=(M, F)) > 0.1) * 1.0
        dm[0] = [1, 0, 0, 0, 0]  # Ndim <= 1: dof <= 0 under the dim prior
    return d, de, dm, m, me, mm


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dim_prior", [True, False])
@pytest.mark.parametrize("branch", ["matmul", "single_sweep", "fixed_point"])
def test_loglike_free_matches_jax(branch, dim_prior, masked):
    """Both branches of `_loglike_free_jit` (ops/likelihood.py:237-422)
    in float64: the matmul one (datum-only variance, 8+ objects), one
    sweep (datum-only variance, fewer objects) and the fixed point with
    model errors; scale and scale_err (return_scale) included."""
    nobj = 5 if branch == "single_sweep" else 24
    prob = _likelihood_problem(nobj, masked)
    kw = dict(ignore_model_err=branch != "fixed_point", dim_prior=dim_prior,
              return_scale=True)
    want = JL.loglike_free(*prob, **kw)
    got = TL.loglike_free(*(torch.from_numpy(x) for x in prob), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-12)
    if masked and dim_prior:
        assert (got.lnlike[0] == -np.inf).all()


@pytest.mark.parametrize("dim_prior", [True, False])
@pytest.mark.parametrize("ignore_model_err", [False, True])
def test_loglike_free_matches_oracle(ignore_model_err, dim_prior):
    """tests/test_likelihood.py::test_loglike_free through the port:
    `loglike(free_scale=True)` (input sanitization included) against the
    reference's per-object loop."""
    rng = np.random.default_rng(1)
    M, F, B = 23, 5, 7
    m = rng.uniform(1.0, 10.0, (M, F))
    me = rng.uniform(0.05, 0.5, (M, F))
    mm = (rng.uniform(size=(M, F)) > 0.1).astype(float)
    d = rng.uniform(1.0, 10.0, (B, F))
    de = rng.uniform(0.1, 1.0, (B, F))
    dm = (rng.uniform(size=(B, F)) > 0.1).astype(float)
    mm[:, :3] = dm[:, :3] = 1.0
    d[3, 4] = np.nan  # cleaned: a masked band
    prob = (d, de, dm, m, me, mm)
    kw = dict(free_scale=True, ignore_model_err=ignore_model_err,
              dim_prior=dim_prior, return_scale=True)
    got = TL.loglike(*(torch.from_numpy(x) for x in prob), **kw)
    want = oracle.loglike(*prob, **kw)
    for k in (0, 2, 3, 4):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6)
    np.testing.assert_array_equal(got.ndim.numpy(), want[1])


def test_logprob_free_scale_matches_jax():
    """The fitters' default lprob with free scale: the 7-field result
    (zero prior, scale and scale_err) equals JAX's."""
    prob = _likelihood_problem(12, masked=True, seed=2)
    want = JL.logprob(*prob, free_scale=True, return_scale=True, ltol=1e-6)
    got = TL.logprob(*(torch.from_numpy(x) for x in prob), free_scale=True,
                     return_scale=True, ltol=1e-6)
    assert len(got) == 7 and (got.lnprior == 0).all()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-12)


# ---------------------------------------------------------------------
# The fused route.
# ---------------------------------------------------------------------


@pytest.mark.parametrize("thresh", list(THRESHOLDS))
@pytest.mark.parametrize("dim_prior", [True, False])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("ignore_model_err", [True, False])
def test_fused_free_scale_matches_jax(problem, ignore_model_err, masked,
                                      dim_prior, thresh):
    """Free scale x {datum-only variance, model errors} x {full, masked}
    x {dim prior, Normal} x {wt_thresh, cdf}, against JAX's kernels (the
    one-pass cases are in tests/test_torch_onepass.py)."""
    prob = problem if masked else _full(problem)
    kw = dict(free_scale=True, ignore_model_err=ignore_model_err,
              dim_prior=dim_prior, **THRESHOLDS[thresh])
    assert TF.fused_route(full_mask=not masked, **{
        k: v for k, v in kw.items() if k != "ignore_model_err"}) == "general"
    got, want = fused_pair(prob, **kw)
    _assert_close(got, want, IME_TOL if ignore_model_err else ME_TOL)


def _jax_tile_sweeps(prob, tm, full_mask, ltol=1e-4, max_iter=100):
    """The sweeps JAX's `_lnl_tile_freescale_me` runs per (object, model
    group): the tile evaluated eagerly on each group of `tm` models, the
    last padded with the glue's sentinels (ops/fused.py:2151-2154), its
    while_loop replaced by a Python loop that records the freeze flags,
    and its reciprocal by a true divide."""
    d, de, dm, m, me, mm = prob[:6]
    M, F = m.shape
    ng = -(-M // tm)
    pad = ng * tm - M
    mp = np.concatenate([m, np.full((pad, F), 1e15, np.float32)])
    mep = np.concatenate([me, np.ones((pad, F), np.float32)])
    mmp = np.concatenate([mm, np.zeros((pad, F), np.float32)])
    valid = np.r_[np.ones(M), np.zeros(pad)].astype(np.float32)[None]
    counts = np.zeros((d.shape[0], ng), np.int64)
    live = []

    def recording_while(cond, body, state):
        while bool(cond(state)):
            live.append(np.asarray(state[3])[:, 0] == 0.0)
            state = body(state)
        return state

    orig_while, orig_recip = jax.lax.while_loop, JF._fast_recip
    jax.lax.while_loop, JF._fast_recip = recording_while, lambda x: 1.0 / x
    try:
        for g in range(ng):
            sl = slice(g * tm, (g + 1) * tm)
            live.clear()
            JF._lnl_tile_freescale_me(
                *(jnp.asarray(x) for x in (d, de, dm, mp[sl].T, mep[sl].T,
                                           mmp[sl].T, valid[:, sl])),
                nfilt=F, dim_prior=False, gl_table=None,
                full_mask=full_mask, ltol=ltol, max_iter=max_iter)
            counts[:, g] = np.sum(live, axis=0) if live else 0
    finally:
        jax.lax.while_loop, JF._fast_recip = orig_while, orig_recip
    return counts


@pytest.mark.parametrize("masked", [True, False])
def test_scale_sweeps_match_the_jax_tile_with_a_ragged_group(problem,
                                                             masked):
    """M = 300 at tm = 128: the last group holds 44 models and 84 of
    JAX's sentinels, which join its maxima of |delta lnl| and A.  The
    table equals the sweeps JAX's tile runs, group for group.  On full
    masks a sentinel's A = sum d^2 / de^2 raises the group's roundoff
    floor, so without it the last group runs more sweeps; on masked data
    (the sentinel observes nothing) its lnl moves only in the first
    sweep, and the counts are those of the 44 models alone."""
    prob = problem if masked else _full(problem)
    want = _jax_tile_sweeps(prob, 128, full_mask=not masked)
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in
         (prob[0], prob[1], prob[2], prob[3].T, prob[4].T, prob[5].T)]
    GK.reset_launch_counts()
    got = GK.scale_sweeps(*t, tm=128, full_mask=not masked).numpy()
    assert GK.launch_counts()["scale_sweeps"] == 0
    np.testing.assert_array_equal(got, want)
    assert want.min() >= 2 and want.max() < 100
    alone = GK.scale_sweeps_plain(*t[:3], *(x[:, 256:].contiguous()
                                            for x in t[3:]),
                                  tm=44, full_mask=not masked).numpy()
    if masked:
        np.testing.assert_array_equal(alone[:, 0], got[:, 2])
    else:
        assert (alone[:, 0] >= got[:, 2]).all()
        assert (alone[:, 0] > got[:, 2]).any()


def test_scale_sweeps_follow_ltol_and_max_iter(problem):
    """A loose ltol freezes every group after one sweep, max_iter caps
    the count, and max_iter = 0 runs none."""
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in
         (problem[0], problem[1], problem[2], problem[3].T, problem[4].T,
          problem[5].T)]
    assert (GK.scale_sweeps(*t, tm=128, ltol=1e6) == 1).all()
    assert (GK.scale_sweeps(*t, tm=128, max_iter=3) <= 3).all()
    assert (GK.scale_sweeps(*t, tm=128, max_iter=0) == 0).all()
    with pytest.raises(ValueError):
        GK.scale_sweeps(*t, tm=0)
    with pytest.raises(ValueError, match="sweep table"):
        GK.lnl_reduce(*t, free_scale=True)


@pytest.mark.parametrize("dim_prior", [True, False])
def test_free_scale_zero_overlap_rows(dim_prior):
    """tests/test_fused.py:282-311 through the port: pairs without a
    common band floor, never NaN; the -inf pattern of the rows equals
    the XLA path's and the finite values agree to 1e-5."""
    from scipy.special import logsumexp

    rng = np.random.default_rng(7)
    B, M, F = 64, 512, 5
    m = rng.uniform(1, 10, (M, F)).astype(np.float32)
    me = (0.05 * m).astype(np.float32)
    mm = (rng.uniform(size=(M, F)) > 0.3).astype(np.float32)
    d = (m[rng.integers(0, M, B)]
         + rng.normal(0, 0.3, (B, F))).astype(np.float32)
    de = np.full((B, F), 0.3, np.float32)
    dm = (rng.uniform(size=(B, F)) > 0.3).astype(np.float32)
    dm[0] = [1, 0, 0, 0, 0]
    G = np.ones((M, 128), np.float32)
    pdf, lmap, levid = to_numpy(TF.fused_fit_pdf(
        d, de, dm, m, me, mm, G, free_scale=True, dim_prior=dim_prior,
        full_mask=False))
    lnp = np.asarray(JL.logprob(d, de, dm, m, me, mm, free_scale=True,
                                dim_prior=dim_prior).lnprob)
    lnp = np.where(np.isnan(lnp), -np.inf, lnp)
    lm2, lv2 = lnp.max(1), logsumexp(lnp, axis=1)
    assert not np.isnan(lmap).any() and np.isfinite(pdf).all()
    np.testing.assert_array_equal(np.isfinite(lmap), np.isfinite(lm2))
    fin = np.isfinite(lm2)
    np.testing.assert_allclose(lmap[fin], lm2[fin], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(levid[fin], lv2[fin], rtol=1e-5, atol=1e-5)


def test_free_scale_dof1_noise_floor():
    """tests/test_fused.py:314-367 through the port: two common bands
    (dof 1) and data that are exact scalings of models, so chi^2 is
    rounding noise; the 16 eps A floor makes lmap deterministic, equal to
    the XLA path at either ltol, and bounded."""
    rng = np.random.default_rng(3)
    B, M, F, Ng = 16, 192, 5, 33
    m = rng.uniform(1, 10, (M, F)).astype(np.float32)
    me = (0.05 * m).astype(np.float32)
    mm = np.ones((M, F), np.float32)
    mm[:, 2:] = 0.0
    d = np.zeros((B, F), np.float32)
    d[:, :2] = 1.7 * m[rng.integers(0, M, B), :2]
    de = np.full((B, F), 0.3, np.float32)
    dm = np.ones((B, F), np.float32)
    G = np.abs(rng.normal(size=(M, Ng))).astype(np.float32)
    G /= G.sum(1, keepdims=True)
    _, lmap, levid = to_numpy(TF.fused_fit_pdf(
        d, de, dm, m, me, mm, G, free_scale=True, dim_prior=True, tm=128))
    assert np.isfinite(lmap).all() and np.isfinite(levid).all()
    for ltol in (1e-6, 1e-4):
        lnp = np.asarray(JL.loglike_free(d, de, dm, m, me, mm,
                                         dim_prior=True, ltol=ltol).lnlike)
        np.testing.assert_allclose(lmap, lnp.max(1), rtol=1e-5, atol=1e-4)
    assert lmap.max() < 10.0


def test_degenerate_pairs_floor_on_every_free_scale_instantiation():
    """tests/test_likelihood.py::test_degenerate_pair_policy_all_paths
    through the port: a model observing nothing, an object with one
    band (Ndim < 2) and an all-masked object give -inf, never NaN."""
    rng = np.random.default_rng(0)
    B, M, F = 8, 12, 5
    m = rng.uniform(1, 10, (M, F))
    mm = np.ones((M, F))
    mm[0] = 0.0
    d = rng.uniform(1, 10, (B, F))
    dmask = np.ones((B, F))
    dmask[1, 1:] = 0.0
    dmask[2] = 0.0
    args = (d, np.full((B, F), 0.3), dmask, m, 0.05 * m, mm)
    G = np.full((M, 33), 1.0 / 33)
    for ime in (False, True):
        lnp = TL.logprob(*(torch.from_numpy(x) for x in args),
                         free_scale=True, ignore_model_err=ime).lnprob
        assert (lnp[:, 0] == -np.inf).all() and (lnp[1:3] == -np.inf).all()
        assert torch.isfinite(lnp[0, 1:]).all()
        pdf, lmap, levid = to_numpy(TF.fused_fit_pdf(
            *args, G, free_scale=True, ignore_model_err=ime))
        assert lmap[1] == lmap[2] == levid[2] == -np.inf
        assert (pdf[1:3] == 0.0).all() and np.isfinite(lmap[0])


def test_fused_route_is_a_kernel_route_for_every_configuration():
    """No plain route is left: every combination of the flags and the
    weight selections goes to a kernel route."""
    import itertools

    for fm, dp, fs, thr in itertools.product(
            (True, False), (True, False), (True, False),
            (dict(), dict(wt_thresh=None, cdf_thresh=2e-4),
             dict(wt_thresh=None, cdf_thresh=None))):
        assert TF.fused_route(full_mask=fm, dim_prior=dp, free_scale=fs,
                              **thr) in ("fullmask", "general", "onepass")


# ---------------------------------------------------------------------
# BruteForce.
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def fitters(problem):
    d, de, dm, m, me, mm, _ = problem
    jbf = JaxBruteForce(m, me, mm)
    rng = np.random.default_rng(0)
    return dict(jax=jbf, torch=TBF.BruteForce(m, me, mm, device="cpu"),
                args=(d, de, dm, rng.uniform(0, 3, len(m)),
                      np.full(len(m), 0.1)),
                kw=dict(label_grid=np.linspace(0, 3, 101), verbose=False,
                        return_gof=True))


def test_fit_track_scale_matches_jax(fitters):
    """`fit(track_scale=True)` stores the free-scale fit's scales where
    the lprob returns them, and leaves ones / zeros where it does not,
    as the JAX fitter does (bruteforce.py:319-347)."""
    jbf, tbf = fitters["jax"], fitters["torch"]
    data = fitters["args"][:3]
    kw = dict(lprob_kwargs=dict(free_scale=True, return_scale=True),
              track_scale=True, verbose=False)
    jbf.fit(*data, **kw)
    tbf.fit(*data, **kw)
    for name in ("fit_scale", "fit_scale_err", "fit_lnprob", "fit_chi2"):
        np.testing.assert_allclose(getattr(tbf, name), getattr(jbf, name),
                                   rtol=2e-5, atol=1e-5)
    assert not (tbf.fit_scale == 1.0).all()
    carried = from_jax_bruteforce(jbf, device="cpu")
    np.testing.assert_array_equal(carried.fit_scale, jbf.fit_scale)
    np.testing.assert_array_equal(carried.fit_scale_err, jbf.fit_scale_err)
    assert carried.NDATA == jbf.NDATA
    tbf.fit(*data, track_scale=True, verbose=False)
    assert (tbf.fit_scale == 1.0).all() and (tbf.fit_scale_err == 0).all()
    tbf.fit(*data, verbose=False)
    assert tbf.fit_scale is None


def test_fit_predict_free_scale_matches_jax(fitters):
    """tests/test_fused.py:217-222 through the port: at ltol 1e-6 (below
    the float32 roundoff floor) the port's kernels, JAX's kernels and
    JAX's XLA path reach the same fixed point."""
    kw = dict(fitters["kw"], lprob_kwargs={"free_scale": True, "ltol": 1e-6})
    got = fitters["torch"].fit_predict(*fitters["args"], **kw)
    for jax_fused in (True, False):
        want = fitters["jax"].fit_predict(*fitters["args"],
                                          use_fused=jax_fused, **kw)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-3, atol=1e-5)
        for k in (0, 1):
            np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-3,
                                       atol=1e-3)


def test_fit_predict_passes_ltol_and_max_iter_to_the_kernels(fitters,
                                                             monkeypatch):
    """`lprob_kwargs` ltol / max_iter reach the sweep counts as
    scale_ltol / scale_max_iter (frankenz_tpu/models/bruteforce.py:
    837-838), and the defaults are JAX's 1e-4 / 100."""
    seen = []
    orig = GK.scale_sweeps_plain

    def spy(*a, **k):
        seen.append((k["ltol"], k["max_iter"]))
        return orig(*a, **k)

    monkeypatch.setattr(GK, "scale_sweeps_plain", spy)
    tbf, args = fitters["torch"], fitters["args"]
    kw = dict(fitters["kw"], return_gof=False)
    loose = tbf.fit_predict(*args, lprob_kwargs={
        "free_scale": True, "ltol": 1e6, "max_iter": 7}, **kw)
    default = tbf.fit_predict(*args, lprob_kwargs={"free_scale": True}, **kw)
    assert seen == [(1e6, 7), (1e-4, 100)]
    direct = TF.fused_fit_pdf(*args[:3], tbf.models, tbf.models_err,
                              tbf.models_mask, tbf._kernel_G(
                                  args[3], args[4], None,
                                  kw["label_grid"])[0],
                              free_scale=True, scale_ltol=1e6,
                              scale_max_iter=7)[0]
    np.testing.assert_allclose(
        loose, (direct / direct.sum(1, keepdim=True)).numpy(), rtol=1e-6,
        atol=1e-7)
    assert not np.allclose(loose, default, rtol=1e-3, atol=1e-5)


def test_fit_predict_track_scale_takes_the_plain_path(fitters, monkeypatch):
    """`track_scale` is not eligible for the kernels (as in JAX,
    bruteforce.py:503-517): it runs the plain composition and, with
    save_fits, stores the scales; the PDFs equal JAX's plain path."""
    monkeypatch.setattr(TF, "fused_fit_pdf", None)  # never called
    tbf, jbf = fitters["torch"], fitters["jax"]
    kw = dict(fitters["kw"], track_scale=True, save_fits=True,
              lprob_kwargs={"free_scale": True, "return_scale": True})
    got = tbf.fit_predict(*fitters["args"], **kw)
    want = jbf.fit_predict(*fitters["args"], use_fused=False, **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tbf.fit_scale, jbf.fit_scale, rtol=2e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        tbf.fit_predict(*fitters["args"], use_fused=True, **kw)
