"""Port parity: the general (masked) route of `fused_fit_pdf` and its
kernels' plain versions, against the JAX package on the CPU.

The port's general route (`lnl_reduce`, `lnl_stack`, `lnl_topk`,
`lnl_cut_stack`, their plain versions on CPU tensors) is held against
JAX's general body, `fused_fit_pdf(..., interpret=True, tb=8, tm=128,
screen=False, band_skip=False)`, on tests/test_fused.py's `problem`
(B=24, M=300, F=5, Ngrid=101, 10% of data and model bands masked).
Tolerances are tests/test_fused.py's: lmap / levid rtol 2e-5, atol 1e-5
and PDFs rtol 1e-3, atol 1e-5 (:58-63; float32 roundoff of the lnl
chain, sums and the stack product in another order); the cdf mode
against the XLA sorted CDF lmap / levid 1e-5 and PDFs rtol 1e-4, atol
1e-6 (:457-462).  Masked `BruteForce` is held against the JAX fitter at
tests/test_torch_bruteforce.py's tolerances.  The bisection cut that
reruns a batch with an undetermined cut is held against the top-T cut
and the XLA sorted CDF.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_numpy
from frankenz_tpu.models import BruteForce as JaxBruteForce
from frankenz_tpu.ops import fused as JF
from frankenz_tpu.ops import kde as JK
from frankenz_tpu.ops import likelihood as JL
from frankenz_tpu.ops import summarize as JS
from frankenz_tpu_torch import FusedCdfFallback
from frankenz_tpu_torch.kernels import general as GK
from frankenz_tpu_torch.models import bruteforce as TBF
from frankenz_tpu_torch.ops import fused as TF
from frankenz_tpu_torch.ops import kde as TK
from frankenz_tpu_torch.ops import pdfs_summarize
from frankenz_tpu_torch.ops import summarize as TS
from frankenz_tpu_torch.utils import from_jax_bruteforce

GOF_TOL = dict(rtol=2e-5, atol=1e-5)
PDF_TOL = dict(rtol=1e-3, atol=1e-5)
CDF_GOF_TOL = dict(rtol=1e-5, atol=1e-5)
CDF_PDF_TOL = dict(rtol=1e-4, atol=1e-6)
CDF = dict(wt_thresh=None, cdf_thresh=2e-4)


@pytest.fixture(scope="module")
def problem():
    """tests/test_fused.py's `problem` fixture, value for value."""
    rng = np.random.default_rng(17)
    B, M, F, Ngrid = 24, 300, 5, 101
    m = rng.uniform(1, 10, (M, F)).astype(np.float32)
    me = (0.05 * m).astype(np.float32)
    mm = (rng.uniform(size=(M, F)) > 0.1).astype(np.float32)
    mm[:, :2] = 1.0
    truth = rng.integers(0, M, B)
    d = (m[truth] + rng.normal(0, 0.3, (B, F))).astype(np.float32)
    de = np.full((B, F), 0.3, np.float32)
    dm = (rng.uniform(size=(B, F)) > 0.1).astype(np.float32)
    dm[:, :2] = 1.0
    G = np.asarray(JK.kernel_matrix(
        rng.uniform(0, 3, M), np.full(M, 0.1), np.linspace(0, 3, Ngrid)),
        np.float32)
    return d, de, dm, m, me, mm, G


def _jax(*args, **kw):
    return to_numpy(JF.fused_fit_pdf(*args, tb=8, tm=128, interpret=True,
                                     screen=False, band_skip=False, **kw))


def _port(*args, **kw):
    return to_numpy(TF.fused_fit_pdf(*args, **kw))


def _assert_close(got, want, gof=GOF_TOL, pdf=PDF_TOL):
    assert got[0].shape == want[0].shape and got[0].dtype == np.float32
    np.testing.assert_allclose(got[1], want[1], **gof)
    np.testing.assert_allclose(got[2], want[2], **gof)
    np.testing.assert_allclose(got[0], want[0], **pdf)


def _full(prob):
    d, de, dm, m, me, mm, G = prob
    return d, de, np.ones_like(dm), m, me, np.ones_like(mm), G


def _tensors(prob):
    """(d, de, dm, mT, meT, mmT) as contiguous CPU tensors."""
    d, de, dm, m, me, mm, _ = prob
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in (d, de, dm, m.T, me.T, mm.T)]


@pytest.mark.parametrize("ignore_model_err", [False, True])
@pytest.mark.parametrize("dim_prior", [True, False])
def test_general_route_matches_jax(problem, dim_prior, ignore_model_err):
    kw = dict(dim_prior=dim_prior, ignore_model_err=ignore_model_err)
    assert TF.fused_route(full_mask=False, dim_prior=dim_prior) == "general"
    _assert_close(_port(*problem, **kw), _jax(*problem, **kw))


@pytest.mark.parametrize("kw", [dict(dim_prior=False), CDF,
                                dict(dim_prior=False, **CDF)],
                         ids=["normal", "cdf", "normal_cdf"])
def test_general_route_on_full_masks_matches_jax(problem, kw):
    """Full masks off the K1 route: the FULL_MASK instantiation."""
    prob = _full(problem)
    assert TF.fused_route(full_mask=True, **kw) == "general"
    _assert_close(_port(*prob, **kw), _jax(*prob, **kw))


@pytest.mark.parametrize("kw", [dict(), CDF], ids=["wt_thresh", "cdf"])
def test_padding_edges(problem, kw):
    """19 x 251 x 77 is ragged against every JAX tile; the port masks the
    edges in-kernel instead of padding."""
    d, de, dm, m, me, mm, G = problem
    prob = (d[:19], de[:19], dm[:19], m[:251], me[:251], mm[:251],
            np.ascontiguousarray(G[:251, :77]))
    got, want = _port(*prob, **kw), _jax(*prob, **kw)
    assert got[0].shape == (19, 77)
    _assert_close(got, want)


def test_all_masked_object(problem):
    d, de, dm, m, me, mm, G = problem
    dm2 = dm.copy()
    dm2[0] = 0.0
    got, want = _port(d, de, dm2, m, me, mm, G), _jax(d, de, dm2, m, me, mm, G)
    assert got[0][0].sum() == 0.0 and got[1][0] == -np.inf
    assert got[2][0] == -np.inf and np.isfinite(got[0][1:]).all()
    _assert_close(got, want)


def test_cdf_all_masked_row_counts_as_determined(problem):
    """JAX flags a cdf-mode call holding an all-masked row (its top-T
    mass is 0), so its BruteForce reruns the batch; the port counts such
    a row as determined -- its PDF is zero by the degenerate-row rule --
    and every row's output equals JAX's."""
    d, de, dm, m, me, mm, G = problem
    dm2 = dm.copy()
    dm2[3] = 0.0
    got = _port(d, de, dm2, m, me, mm, G, defer_cdf_check=True, **CDF)
    want = _jax(d, de, dm2, m, me, mm, G, defer_cdf_check=True, **CDF)
    assert bool(got[3]) and not bool(want[3])
    assert got[0][3].sum() == 0.0 and got[1][3] == -np.inf
    _assert_close(got[:3], want[:3], CDF_GOF_TOL, CDF_PDF_TOL)


@pytest.mark.parametrize("dim_prior", [True, False])
def test_zero_overlap_pairs_do_not_poison_rows(dim_prior):
    """tests/test_fused.py:241-280 through the port: pairs with no
    common band floor at float32 min, never NaN, and each row's lmap /
    levid match the NaN-cleaned XLA reference."""
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
    dm[0] = [1, 0, 0, 0, 0]  # zero-overlap pairs exist
    G = np.ones((M, 128), np.float32)
    pdf, lmap, levid = _port(d, de, dm, m, me, mm, G, dim_prior=dim_prior,
                             full_mask=False)
    res = JL.logprob(jnp.asarray(d), jnp.asarray(de), jnp.asarray(dm),
                     jnp.asarray(m), jnp.asarray(me), jnp.asarray(mm),
                     dim_prior=dim_prior)
    lnp = np.asarray(res.lnprob)
    lnp = np.where(np.isnan(lnp), -np.inf, lnp)
    assert np.isfinite(lmap).all(), "poisoned rows"
    assert np.isfinite(pdf).all()
    np.testing.assert_allclose(lmap, lnp.max(1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(levid, logsumexp(lnp, axis=1), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("masked", [True, False])
def test_cdf_mode_matches_xla_sorted_cdf(problem, masked):
    """The on-device cut == the XLA sorted-CDF selection, including the
    reference's drop-the-largest-weight quirk (test_fused.py:439-462)."""
    prob = problem if masked else _full(problem)
    d, de, dm, m, me, mm, G = prob
    got = _port(*prob, **CDF)
    lnp = JL.logprob(d, de, dm, m, me, mm).lnprob
    want_lmap = np.asarray(jnp.max(lnp, axis=1))
    want_levid = np.asarray(jax.scipy.special.logsumexp(lnp, axis=1))
    wt = JK.threshold_weights(jnp.exp(lnp - want_levid[:, None]), None,
                              2e-4)
    assert (np.asarray(wt)[np.arange(wt.shape[0]),
                           np.argmax(np.asarray(lnp), axis=1)] == 0).all()
    want = (np.asarray(wt @ jnp.asarray(G, jnp.float32)), want_lmap,
            want_levid)
    _assert_close(got, want, CDF_GOF_TOL, CDF_PDF_TOL)


def _flat(problem):
    d, de, dm, m, me, mm, G = problem
    d0 = np.tile(m[:1], (d.shape[0], 1))
    return d0, de, np.ones_like(dm), m, me, np.ones_like(mm), G


def test_cdf_flat_posterior_raises(problem):
    """test_fused.py:465-479: the top-2 values of a flat posterior carry
    < cdf_thresh of the mass, and the port raises its fallback signal."""
    with pytest.raises(FusedCdfFallback):
        TF.fused_fit_pdf(*_flat(problem), wt_thresh=None,
                         cdf_thresh=0.999999, cdf_topk=2)


def test_cdf_defer_flag_instead_of_raise(problem):
    """test_fused.py:482-501: defer_cdf_check returns the flag (False on
    the flat posterior, as JAX's) and, on a determinate cut, True and
    the eager call's exact output."""
    kw = dict(wt_thresh=None, cdf_thresh=0.999999, cdf_topk=2,
              defer_cdf_check=True)
    got = _port(*_flat(problem), **kw)
    want = _jax(*_flat(problem), **kw)
    assert len(got) == 4 and not bool(got[3]) and not bool(want[3])
    out = TF.fused_fit_pdf(*problem, defer_cdf_check=True, **CDF)
    assert isinstance(out[3], torch.Tensor) and bool(out[3])
    eager = TF.fused_fit_pdf(*problem, **CDF)
    for a, b in zip(out[:3], eager):
        assert torch.equal(a, b)
    flag = TF.fused_fit_pdf(*problem, defer_cdf_check=True)[3]
    assert bool(flag)


def test_cdf_cut_matches_jax():
    """`cdf_cut`'s cut and flag == JAX `_cdf_cut` on random top-T tables,
    bit for bit, including undetermined rows (cut +inf) and straddling
    tie groups (whose split JAX does not return)."""
    rng = np.random.default_rng(5)
    B, T = 64, 6
    vals = -np.sort(rng.exponential(2.0, (B, T)), axis=1).astype(np.float32)
    vals[:8, 3:] = np.finfo(np.float32).min
    cnts = rng.integers(1, 4, (B, T)).astype(np.float32)
    cnts[:8, 3:] = 0.0
    levid = (vals[:, 0] + rng.uniform(0.0, 2.0, B)).astype(np.float32)
    for thr in (2e-4, 0.3, 0.999):
        cut_j, ok_j = JF._cdf_cut(jnp.asarray(vals), jnp.asarray(cnts),
                                  jnp.asarray(levid), thr)
        cut_t, _, _, ok_t = TF.cdf_cut(torch.from_numpy(vals),
                                       torch.from_numpy(cnts),
                                       torch.from_numpy(levid), thr)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_array_equal(cut_t.numpy(), np.asarray(cut_j))


def test_cdf_cut_splits_a_straddling_tie_group():
    """A group of equal weights straddling the boundary loses only as
    many members as the reference's sorted CDF drops: j members go while
    excl + j * g < cdf_thresh; the rest are kept."""
    g = 0.1
    vals = torch.log(torch.tensor([[0.3, g, 0.01, 0.001]]))
    cnts = torch.tensor([[1.0, 4.0, 2.0, 5.0]])
    levid = torch.zeros(1)
    for thr, cut_slot, nkeep in ((0.25, 1, 0.0), (0.35, 2, 3.0),
                                 (0.55, 2, 1.0), (0.65, 2, 0.0)):
        cut, tie, nk, ok = TF.cdf_cut(vals, cnts, levid, thr)
        assert bool(ok[0]) and float(cut[0]) == float(vals[0, cut_slot])
        assert float(nk[0]) == nkeep
        assert float(tie[0]) == (float(vals[0, 1]) if nkeep else np.inf)


def test_cdf_straddling_tie_group_matches_the_reference(problem):
    """Fault found by the port's card run: float32 lnl values tie (two
    models with one lnl), and a tie group that straddles the cdf cut
    dropped whole in the JAX kernels (`_cdf_cut`, ops/fused.py:823-825).
    The reference's sorted CDF drops only part of it.  Model 0 twice and
    data row 0 at chi^2 = 3 from it (the F = 5 dim prior's peak) make the
    top group a pair; cdf_thresh below one member's mass makes it
    straddle (the reference drops the first member only).  The port
    equals the XLA sorted-CDF result; JAX's fused route does not."""
    d, de, dm, m, me, mm, G = _full(problem)
    m2, me2 = np.concatenate([m[:1], m]), np.concatenate([me[:1], me])
    mm2, G2 = np.concatenate([mm[:1], mm]), np.concatenate([G[:1], G])
    d2 = d.copy()
    d2[0] = m[0] + np.sqrt(0.6 * (de[0] ** 2 + me[0] ** 2))
    lnp = np.asarray(JL.logprob(d2, de, dm, m2, me2, mm2).lnprob)
    levid = np.asarray(jax.scipy.special.logsumexp(lnp, axis=1))
    g0 = float(np.exp(lnp[0].max() - levid[0]))
    assert lnp[0, 0] == lnp[0, 1] == lnp[0].max() and 2 * g0 < 1.0
    thr = 0.5 * g0
    wt = JK.threshold_weights(jnp.exp(lnp - levid[:, None]), None, thr)
    want = np.asarray(wt @ jnp.asarray(G2, jnp.float32))
    kw = dict(wt_thresh=None, cdf_thresh=thr)
    got = _port(d2, de, dm, m2, me2, mm2, G2, **kw)
    np.testing.assert_allclose(got[0], want, **CDF_PDF_TOL)
    np.testing.assert_allclose(got[1], lnp.max(1), **CDF_GOF_TOL)
    jax_fused = _jax(d2, de, dm, m2, me2, mm2, G2, **kw)[0]
    assert not np.allclose(jax_fused[0], want[0], **CDF_PDF_TOL)
    # The bisection splits the group the same way (cdf_topk=1 leaves
    # every cut undetermined).
    exact = _port(d2, de, dm, m2, me2, mm2, G2, cdf_topk=1, cdf_exact=True,
                  **kw)
    np.testing.assert_allclose(exact[0], want, **CDF_PDF_TOL)


def _topk_reference(lnl, T):
    floor = np.finfo(np.float32).min
    vals = np.full((lnl.shape[0], T), floor, np.float32)
    cnts = np.zeros((lnl.shape[0], T), np.float32)
    for b, row in enumerate(lnl):
        u, c = np.unique(row[row > floor], return_counts=True)
        u, c = u[::-1][:T], c[::-1][:T]
        vals[b, :len(u)] = u
        cnts[b, :len(u)] = c
    return vals, cnts


@pytest.mark.parametrize("T", [3, 8, 40])
@pytest.mark.parametrize("masked", [True, False])
def test_topk_plain_counts_ties_of_duplicate_models(problem, T, masked):
    """Duplicate models tie: the T heaviest distinct values (descending)
    with their counts, float32 min / 0 past the distinct values, equal to
    a numpy unique / counts reference; the wrapper on CPU tensors runs
    the plain version and launches nothing."""
    d, de, dm, m, me, mm, G = problem if masked else _full(problem)
    dup = np.concatenate([m[:60], m[:60], m[:20]])  # 60 distinct, ties
    prob = (d, de, dm, dup, (0.05 * dup).astype(np.float32),
            np.concatenate([mm[:60], mm[:60], mm[:20]]), G)
    t = _tensors(prob)
    flags = dict(full_mask=not masked)
    lnl = GK.lnl_tile_plain(*t, **flags).numpy()
    want = _topk_reference(lnl, T)
    GK.reset_launch_counts()
    got = GK.lnl_topk(*t, T=T, **flags)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert got[1].numpy()[:, 0].max() >= 2.0  # ties were pooled
    assert GK.launch_counts()["lnl_topk"] == 0


@pytest.mark.parametrize("dim_prior", [True, False])
def test_lnl_tile_plain_matches_jax_loglike(problem, dim_prior):
    """The plain lnl grid == JAX `loglike_fixed`, with zero-overlap /
    Ndim-0 pairs at the float32-min floor where JAX has -inf."""
    d, de, dm, m, me, mm, _ = problem
    dm = dm.copy()
    dm[1] = [1, 0, 0, 0, 0]
    got = GK.lnl_tile_plain(*_tensors((d, de, dm, m, me, mm, None)),
                            dim_prior=dim_prior).numpy()
    want = np.asarray(JL.loglike_fixed(d, de, dm, m, me, mm,
                                       dim_prior=dim_prior).lnlike)
    want = np.maximum(np.where(np.isnan(want), -np.inf, want),
                      np.finfo(np.float32).min)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------
# BruteForce on masked photometry.
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def masked_fit():
    rng = np.random.default_rng(4)
    B, M, F, Ngrid = 200, 1000, 5, 101
    f32 = np.float32
    models = rng.uniform(1, 10, (M, F)).astype(f32)
    mmask = (rng.uniform(size=(M, F)) > 0.1).astype(f32)
    data = (models[rng.integers(0, M, B)]
            + rng.normal(0, 0.25, (B, F))).astype(f32)
    dmask = (rng.uniform(size=(B, F)) > 0.15).astype(f32)
    dmask[7] = 0.0  # one all-masked object
    p = dict(models=(models, (0.05 * models).astype(f32), mmask),
             args=(data, np.full((B, F), 0.25, f32), dmask,
                   rng.uniform(0, 3, M), np.full(M, 0.1)),
             kw=dict(label_grid=np.linspace(0, 3, Ngrid), verbose=False,
                     return_gof=True))
    p["jax"] = JaxBruteForce(*p["models"])
    p["torch"] = from_jax_bruteforce(p["jax"], device="cpu")
    return p


def _assert_fit_close(got, want, gof=dict(rtol=2e-5, atol=2e-5),
                      pdf=dict(rtol=2e-3, atol=2e-5)):
    np.testing.assert_allclose(got[1][0], want[1][0], **gof)
    np.testing.assert_allclose(got[1][1], want[1][1], **gof)
    np.testing.assert_allclose(got[0], want[0], **pdf)


@pytest.mark.parametrize("jax_fused", [True, False])
def test_masked_fit_predict_matches_jax(masked_fit, jax_fused):
    p = masked_fit
    got = p["torch"].fit_predict(*p["args"], **p["kw"])
    want = p["jax"].fit_predict(*p["args"], use_fused=jax_fused, **p["kw"])
    _assert_fit_close(got, want)
    assert got[0][7].sum() == 0.0 and got[1][0][7] == -np.inf
    rows = np.delete(got[0].sum(1), 7)
    np.testing.assert_allclose(rows, 1.0, rtol=1e-5)


def test_masked_fit_summarize_matches_jax_and_own_pdfs(masked_fit):
    p = masked_fit
    kw = dict(label_grid=p["kw"]["label_grid"], verbose=False)
    got, gof = p["torch"].fit_summarize(*p["args"], **kw)
    want, _ = p["jax"].fit_summarize(*p["args"], use_fused=True, **kw)
    cols = np.asarray(JS._pack_summary(got))
    np.testing.assert_allclose(cols, np.asarray(JS._pack_summary(want)),
                               rtol=2e-3, atol=2e-4)
    pdfs = p["torch"].fit_predict(*p["args"], **p["kw"])[0]
    u = np.random.default_rng(0).random(len(pdfs))
    own = pdfs_summarize(torch.from_numpy(pdfs), p["kw"]["label_grid"], u=u)
    np.testing.assert_allclose(cols, to_numpy(TS._pack_summary(own)),
                               rtol=2e-5, atol=2e-6)


def test_masked_cdf_fit_predict_matches_jax_without_reruns(masked_fit):
    p = masked_fit
    kw = dict(p["kw"], **CDF)
    bf = p["torch"]
    got = bf.fit_predict(*p["args"], batch_size=64, **kw)
    assert bf.cdf_reruns == 0
    want = p["jax"].fit_predict(*p["args"], use_fused=False, **kw)
    _assert_fit_close(got, want, CDF_GOF_TOL, CDF_PDF_TOL)


def test_bruteforce_cdf_rerun_of_flagged_batches(masked_fit, monkeypatch):
    """tests/test_fused.py:504-540 through the port: every batch's
    deferred flag comes back False, so every batch reruns with
    ``cdf_exact=True``.  On these rows the top-T table settles every cut,
    so each rerun equals the unflagged fit bit for bit; both equal the
    plain composition at the cdf tolerances."""
    p = masked_fit
    kw = dict(p["kw"], **CDF)
    bf = p["torch"]
    want = bf.fit_predict(*p["args"], use_fused=False, **kw)
    unflagged = bf.fit_predict(*p["args"], batch_size=64, **kw)
    orig = TBF._fused.fused_fit_pdf
    calls = []

    def always_flagged(*a, **k):
        out = orig(*a, **k)
        calls.append((k["defer_cdf_check"], k.get("cdf_exact", False)))
        if k["defer_cdf_check"]:
            return out[0], out[1], out[2], torch.tensor(False)
        return out

    monkeypatch.setattr(TBF._fused, "fused_fit_pdf", always_flagged)
    got = bf.fit_predict(*p["args"], batch_size=64, **kw)
    assert bf.cdf_reruns == 4
    assert calls == [(True, False)] * 4 + [(False, True)] * 4
    for g, u in ((got[0], unflagged[0]), (got[1][0], unflagged[1][0]),
                 (got[1][1], unflagged[1][1])):
        np.testing.assert_array_equal(g, u)
    _assert_fit_close(got, want, CDF_GOF_TOL, CDF_PDF_TOL)


@pytest.mark.parametrize("cdf_thresh", [0.999999, 0.5])
def test_bruteforce_flat_posterior_reruns_and_matches_plain(problem,
                                                            cdf_thresh):
    """A flat posterior (data errors 100x the model spread) leaves the
    cut undetermined at the default cdf_topk: the batch is flagged,
    reruns with the bisection cut, and equals the plain composition.
    At 0.999999 the reference keeps nothing; at 0.5 the cut lies in the
    middle of the near-equal weights."""
    d0, de, dm, m, me, mm, _ = _flat(problem)
    # Off model 0 by 0.37 in every band: at chi^2 = 0 the plain
    # composition's dim prior gives lnl = -inf and the kernels' clamp
    # (chi^2 >= 1e-30, as JAX `_lnl_tile`) a tiny weight, which is the
    # only weight the reference keeps at cdf_thresh=0.999999.
    d0, de = d0 + np.float32(0.37), np.full_like(de, 1e3)
    bf = TBF.BruteForce(m, me, mm, device="cpu")
    z = np.random.default_rng(0).uniform(0, 3, len(m))
    args = (d0, de, dm, z, np.full(len(m), 0.1))
    kw = dict(label_grid=np.linspace(0, 3, 41), verbose=False,
              return_gof=True, wt_thresh=None, cdf_thresh=cdf_thresh)
    got = bf.fit_predict(*args, **kw)
    assert bf.cdf_reruns == 1
    want = bf.fit_predict(*args, use_fused=False, **kw)
    _assert_fit_close(got, want, CDF_GOF_TOL, CDF_PDF_TOL)
    if cdf_thresh > 0.9:
        np.testing.assert_array_equal(got[0], want[0])
    else:
        assert (got[0].sum(1) > 0.99).all()


# ---------------------------------------------------------------------
# The bisection cut (`cdf_cut_exact`).
# ---------------------------------------------------------------------


@pytest.mark.parametrize("thr", [2e-4, 0.05, 0.5])
@pytest.mark.parametrize("masked", [True, False])
def test_cdf_cut_exact_selects_what_the_reference_selects(problem, masked,
                                                          thr):
    """The bisection's selection, stacked through an identity G, equals
    the port's plain sorted-CDF weights (`threshold_weights`) bit for
    bit.  Models 0-59 appear twice, so tie groups straddle the boundary;
    with T = M the top-T cut agrees on every pair outside them (its
    split of a group whose members straddle cdf_thresh within rounding
    may differ)."""
    d, de, dm, m, me, mm, _ = problem if masked else _full(problem)
    idx = np.concatenate([np.arange(60), np.arange(300)])
    t = _tensors((d, de, dm, m[idx], me[idx], mm[idx], None))
    flags = dict(full_mask=not masked)
    _, levid = GK.lnl_reduce_plain(*t, **flags)
    cut, tie, nkeep = TF.cdf_cut_exact(*t, levid, thr, **flags)
    eye = torch.eye(len(idx))
    got = GK.lnl_cut_stack_plain(*t, eye, cut, levid, tie, nkeep, **flags)
    lnl = GK.lnl_tile_plain(*t, **flags)
    want = TK.threshold_weights(torch.exp(lnl - levid[:, None]), None, thr)
    assert torch.equal(got, want)
    vals, cnts = GK.lnl_topk_plain(*t, T=len(idx), **flags)
    tcut, _, _, ok = TF.cdf_cut(vals, cnts, levid, thr)
    assert bool(ok.all())
    assert torch.equal(lnl <= cut[:, None], lnl <= tcut[:, None])


@pytest.mark.parametrize("thr", [2e-4, 0.3])
@pytest.mark.parametrize("masked", [True, False])
def test_cdf_exact_route_matches_xla_sorted_cdf(problem, masked, thr):
    """cdf_topk=1 leaves every cut undetermined (the top value's
    exclusive mass is 0); ``cdf_exact=True`` finds them all by bisection
    and equals the XLA sorted-CDF selection, as the top-T route does in
    test_cdf_mode_matches_xla_sorted_cdf."""
    prob = problem if masked else _full(problem)
    d, de, dm, m, me, mm, G = prob
    kw = dict(wt_thresh=None, cdf_thresh=thr, cdf_topk=1)
    assert not bool(_port(*prob, defer_cdf_check=True, **kw)[3])
    got = _port(*prob, cdf_exact=True, **kw)
    lnp = JL.logprob(d, de, dm, m, me, mm).lnprob
    levid = np.asarray(jax.scipy.special.logsumexp(lnp, axis=1))
    wt = JK.threshold_weights(jnp.exp(lnp - levid[:, None]), None, thr)
    want = (np.asarray(wt @ jnp.asarray(G, jnp.float32)),
            np.asarray(jnp.max(lnp, axis=1)), levid)
    _assert_close(got, want, CDF_GOF_TOL, CDF_PDF_TOL)
