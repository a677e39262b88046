"""Port parity: the screened full-mask route (`ops.screen`, the K2
kernels' plain versions on the CPU) against JAX's
`_fused_call_fullmask_dimprior_screened`, run in interpret mode as
tests/test_fused.py runs it (tb=8, tm=128 or 512).

Tolerances:
- the route against JAX: tests/test_fused.py:114-119's, lmap / levid
  rtol 2e-5, atol 2e-5 (float32 roundoff of the bracket -> lnl glue, and
  the weight sum taken in another order: the port's object blocks and
  visit order are its own); PDFs rtol 2e-3, atol 2e-5 (the same weights
  stacked in another order; a weight on the threshold may flip);
- screened against run-all, and absorption on against off: bit for bit
  (every skip is exact, ops/fused.py:1060-1064); the screened lmap
  against the two-pass pair's: bit for bit (max and min do not depend
  on order), levid 1e-6;
- the run fractions at JAX's own block and subtile (tb=8, 512): equal
  to JAX's; with wt_thresh=None, absorption on against off: equal;
- `interleave2`, the sort permutations: equal; the subtile bounds and
  the anchor seeds: 1e-6 relative (the same float32 operations; they
  agree bit for bit here);
- `chi2_upper_root`: 2.5e-6 relative to JAX's root, a quarter of the
  root's own (1 + 1e-5) inflation, and never under the root (f(cut) <= K
  in float64).  Not 1 ulp: JAX's CPU `log` is not correctly rounded
  (0.98 ulp measured against torch's 0.50) and XLA contracts
  a1 log(c) - c/2 into an FMA, so the float32 Newton iterates part by a
  few ulps, more where f' -> 0 near the peak (29 ulp at F = 40);
- each bound below every chi^2 of its subtile (exact compare).
"""

import numpy as np
import pytest
import torch

from frankenz_tpu.ops import fused as JF
from frankenz_tpu.ops.fused import fused_fit_pdf as jax_fused_fit_pdf

from _torch_port import fullmask_problem, run_both, to_numpy
from frankenz_tpu_torch import kernels as K
from frankenz_tpu_torch.kernels import fullmask as FM
from frankenz_tpu_torch.kernels import screened as SCK
from frankenz_tpu_torch.ops import fused as TF
from frankenz_tpu_torch.ops import screen as SC

GOF_TOL = dict(rtol=2e-5, atol=2e-5)
PDF_TOL = dict(rtol=2e-3, atol=2e-5)


def _jax(*args, tm=128, **kw):
    return jax_fused_fit_pdf(*args, tb=8, tm=tm, interpret=True, **kw)


def _assert_close(want, got):
    assert got[0].shape == want[0].shape and got[0].dtype == np.float32
    np.testing.assert_allclose(got[1], want[1], **GOF_TOL)
    np.testing.assert_allclose(got[2], want[2], **GOF_TOL)
    np.testing.assert_allclose(got[0], want[0], **PDF_TOL)


def _assert_bitwise(a, b, what=""):
    for x, y, name in zip(a[:3], b[:3], ("pdf", "lmap", "levid")):
        np.testing.assert_array_equal(to_numpy(x), to_numpy(y),
                                      err_msg=f"{what} {name}")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def locality_problem():
    """tests/test_fused.py:690-700: models along a photometric line,
    objects clustered at one end of it."""
    rng = np.random.default_rng(3)
    M, B, F, Ng = 4096, 64, 5, 65
    t = np.sort(rng.uniform(0, 1, M)).astype(np.float32)
    m = (1.0 + 9.0 * t)[:, None] * np.linspace(1., 2., F)[None, :]
    m = (m + rng.normal(0, .02, (M, F))).astype(np.float32)
    me = (0.02 * m).astype(np.float32)
    d = (m[rng.integers(0, 400, B)]
         + rng.normal(0, .05, (B, F))).astype(np.float32)
    de = np.full((B, F), .05, np.float32)
    G = np.abs(rng.normal(size=(M, Ng))).astype(np.float32)
    G /= G.sum(1, keepdims=True)
    return d, de, np.ones_like(d), m, me, np.ones_like(m), G


def clamped_problem():
    """tests/test_fused.py:644-650: every chi^2 past the 3e4 clamp."""
    rng = np.random.default_rng(1)
    B, M, F, Ng = 8, 3, 3, 33
    m = rng.uniform(1, 2, (M, F)).astype(np.float32)
    d = np.full((B, F), 1e6, np.float32)
    de = np.full((B, F), 1.0, np.float32)
    G = np.abs(rng.normal(size=(M, Ng))).astype(np.float32)
    G /= G.sum(1, keepdims=True)
    return d, de, np.ones_like(d), m, np.zeros_like(m), np.ones_like(m), G


def _glue(prob, **kw):
    """`ops.screen.screened` straight on a problem's tensors."""
    d, de, _, m, me, _, G = prob
    kw.setdefault("ignore_model_err", False)
    kw.setdefault("wt_thresh", 1e-3)
    return SC.screened(_t(d), _t(de), _t(m.T), _t(me.T), _t(G), **kw)


def test_full_masks_take_the_screened_route_by_default():
    assert TF.fused_route(full_mask=True) == "screened"
    assert TF.fused_route(full_mask=True, screen=None) == "screened"
    assert TF.fused_route(full_mask=True, screen=False) == "fullmask"
    prob = fullmask_problem(5, outlier_row=False)
    with pytest.raises(ValueError, match="screened route"):
        TF.fused_fit_pdf(*prob, screen=False, screen_stats=True)
    out = TF.fused_fit_pdf(*prob, screen_stats=True)
    assert len(out) == 4 and out[3].shape == (3,)
    assert bool(((out[3] >= 0) & (out[3] <= 1)).all())


@pytest.mark.parametrize("ignore_model_err", [False, True])
@pytest.mark.parametrize("wt_thresh", [1e-3, None])
@pytest.mark.parametrize("nfilt", [2, 5, 8, 20])
def test_default_route_matches_jax_screened(nfilt, wt_thresh,
                                            ignore_model_err):
    """F=2 is a1 = 0, F=5/8 the sqrt chain, F=20 the log form; B=19,
    M=251, Ngrid=77 are ragged against every block and subtile; row 0 is
    an all-clamped outlier."""
    prob = fullmask_problem(nfilt)
    want, got = run_both(_jax, TF.fused_fit_pdf, *prob, wt_thresh=wt_thresh,
                         ignore_model_err=ignore_model_err,
                         jax_kw=dict(screen=True))
    _assert_close(want, got)
    assert np.isfinite(got[0]).all()


@pytest.mark.parametrize("wt_thresh", [1e-3, None])
def test_locality_problem_matches_jax(wt_thresh):
    """At JAX's block (tb=8) and subtile (512) the run fractions are
    JAX's exactly; the route itself (32-row blocks) matches JAX's
    results."""
    prob = locality_problem()
    want, got = run_both(_jax, TF.fused_fit_pdf, *prob, tm=512,
                         wt_thresh=wt_thresh, screen_stats=True)
    _assert_close(want, got)
    glue = _glue(prob, wt_thresh=wt_thresh, sm=512, tm=512, tb=8,
                 with_stats=True)
    np.testing.assert_array_equal(to_numpy(glue[3]), want[3])
    _assert_close(want, to_numpy(glue))


def test_all_clamped_rows_match_jax_and_never_skip():
    """The floored-shift rows keep every pass-B subtile (the cuts are
    +inf: w(clamp) stays live), and their GOF matches JAX's at float32."""
    prob = clamped_problem()
    kw = dict(ignore_model_err=True, screen_stats=True)
    want, got = run_both(_jax, TF.fused_fit_pdf, *prob, **kw)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-7)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-7)
    np.testing.assert_allclose(got[0], want[0], **PDF_TOL)
    np.testing.assert_array_equal(got[3][1:], 1.0)
    ra = TF.fused_fit_pdf(*prob, ignore_model_err=True, screen_run_all=True)
    _assert_bitwise(got, ra)


@pytest.mark.parametrize("home_first", [True, False])
@pytest.mark.parametrize("absorb", [True, False])
@pytest.mark.parametrize("wt_thresh", [1e-3, None])
@pytest.mark.parametrize("case", ["locality", "fullmask_f5", "fullmask_f20",
                                  "clamped"])
def test_plain_screened_equals_plain_run_all(case, wt_thresh, absorb,
                                             home_first):
    """Every skip of the plain versions is exact, at 8-row blocks (more
    blocks, more gates) and at the kernels' 32."""
    prob = {"locality": locality_problem,
            "fullmask_f5": lambda: fullmask_problem(5, B=70, M=700),
            "fullmask_f20": lambda: fullmask_problem(20, B=70, M=700),
            "clamped": clamped_problem}[case]()
    for tb, sm, tm in ((8, 128, 256), (32, 256, 512)):
        kw = dict(wt_thresh=wt_thresh, sm=sm, tm=tm, tb=tb, absorb=absorb,
                  home_first=home_first)
        scr = _glue(prob, **kw)
        ra = _glue(prob, run_all=True, **kw)
        _assert_bitwise(scr, ra, f"tb={tb}")


def test_absorption_lowers_pass_b_and_changes_no_bit():
    """tests/test_fused.py:679-727 through the port: absorption strictly
    lowers pass B's run fraction on the locality problem, under both
    visit orders, and leaves every output bit as it was; with
    wt_thresh=None it is neutralised: the run fractions are equal."""
    prob = locality_problem()
    for home_first in (True, False):
        kw = dict(screen_sub=256, screen_stats=True,
                  screen_home_first=home_first)
        on = TF.fused_fit_pdf(*prob, screen_absorb=True, **kw)
        off = TF.fused_fit_pdf(*prob, screen_absorb=False, **kw)
        _assert_bitwise(on, off)
        assert float(on[3][1]) < float(off[3][1])
        on_n = TF.fused_fit_pdf(*prob, wt_thresh=None, screen_absorb=True,
                                **kw)
        off_n = TF.fused_fit_pdf(*prob, wt_thresh=None, screen_absorb=False,
                                 **kw)
        torch.testing.assert_close(on_n[3], off_n[3], rtol=0, atol=0)
        _assert_bitwise(on_n, off_n)


def test_screened_lmap_equals_the_two_pass_pair():
    """max / min do not depend on order: the screened lmap is the K1
    pair's bit for bit; levid and PDFs within float32 reassociation."""
    prob = locality_problem()
    scr = to_numpy(TF.fused_fit_pdf(*prob))
    k1 = to_numpy(TF.fused_fit_pdf(*prob, screen=False))
    np.testing.assert_array_equal(scr[1], k1[1])
    np.testing.assert_allclose(scr[2], k1[2], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(scr[0], k1[0], **PDF_TOL)


def test_interleave2_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 1 << 15, 4096).astype(np.int32)
            for _ in range(2))
    a[:3], b[:3] = (0, 32767, 12345), (32767, 0, 32767)
    want = np.asarray(JF._interleave2(jnp.asarray(a), jnp.asarray(b)))
    got = SC.interleave2(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nfilt", [1, 2, 5, 8, 20])
def test_chi2_upper_root_matches_jax_and_never_undercuts(nfilt):
    import jax.numpy as jnp

    a1 = 0.5 * nfilt - 1.0
    c0 = 2.0 * a1
    peak = a1 * np.log(c0) - c0 / 2 if a1 > 0 else 0.0
    rng = np.random.default_rng(nfilt)
    K = (peak - np.concatenate([rng.uniform(0.0, 150.0, 2000),
                                [0.5, 24.6, 104.2, 6.9]])).astype(np.float32)
    want = np.asarray(JF._chi2_upper_root(a1, jnp.asarray(K), c0))
    got = SC.chi2_upper_root(a1, _t(K), c0).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2.5e-6, atol=0)
    c = got.astype(np.float64)
    f = (a1 * np.log(c) if a1 else 0.0) - 0.5 * c
    assert np.all(f <= K.astype(np.float64))
    assert np.all(c > c0)


@pytest.mark.parametrize("ignore_model_err", [False, True])
@pytest.mark.parametrize("nfilt", [2, 5, 20])
def test_screen_prep_matches_jax(nfilt, ignore_model_err):
    """M = 256 is a whole number of 64-model subtiles, so JAX has no
    sentinel models and its boxes are the port's."""
    import jax.numpy as jnp

    d, de, _, m, me, _, G = fullmask_problem(nfilt, B=40, M=256)
    c0 = nfilt - 2.0
    jd, _, jmT, _, _, jb, js, jinv = JF._screen_prep(
        *(jnp.asarray(x) for x in (d, de, m.T, me.T, G)), 256, 64, 256, c0,
        ignore_model_err)
    operm, mperm, bounds, seed = SC.screen_prep(
        _t(d), _t(de), _t(m.T), _t(me.T), 64, c0, ignore_model_err)
    np.testing.assert_array_equal(operm.numpy(), np.argsort(np.asarray(jinv)))
    np.testing.assert_array_equal(m.T[:, mperm.numpy()], np.asarray(jmT))
    np.testing.assert_array_equal(d[operm.numpy()], np.asarray(jd))
    np.testing.assert_allclose(bounds.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(seed.numpy(), np.asarray(js)[0], rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("ignore_model_err", [False, True])
@pytest.mark.parametrize("case", ["fullmask", "locality"])
def test_each_bound_is_below_every_chi2_of_its_subtile(case,
                                                       ignore_model_err):
    prob = (fullmask_problem(5, B=60, M=1000, outlier_row=False)
            if case == "fullmask" else locality_problem())
    d, de, _, m, me, _, _ = prob
    sm = 96  # ragged last subtile on both problems
    operm, mperm, bounds, _ = SC.screen_prep(
        _t(d), _t(de), _t(m.T), _t(me.T), sm, 3.0, ignore_model_err)
    chi2 = FM._chi2_plain(_t(d)[operm], _t(de)[operm], _t(m.T)[:, mperm],
                          _t(me.T)[:, mperm], ignore_model_err)
    M = m.shape[0]
    S = bounds.shape[0]
    assert S == -(-M // sm)
    pad = torch.nn.functional.pad(chi2, (0, S * sm - M), value=torch.inf)
    sub_min = pad.reshape(chi2.shape[0], S, sm).amin(dim=2).T      # (S, B)
    assert bool((bounds <= sub_min).all())
    # ... and not vacuous: most bounds are positive.
    assert float((bounds > 0).float().mean()) > 0.5


# ---------------------------------------------------------------------
# The seed stage (`kernels.screened.screen_bound_seed`): its plain
# version against JAX's `_screen_prep` and against the earlier glue.
# ---------------------------------------------------------------------

def _same_bits(got, want, what=""):
    """NaN in the same places, every other entry equal bit for bit."""
    got, want = to_numpy(got), to_numpy(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    nan = np.isnan(want) if want.dtype.kind == "f" else np.zeros(
        want.shape, bool)
    np.testing.assert_array_equal(np.isnan(got) if got.dtype.kind == "f"
                                  else nan, nan, err_msg=what)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32), err_msg=what)


@pytest.mark.parametrize("ignore_model_err", [False, True])
@pytest.mark.parametrize("nfilt", [2, 5, 20])
def test_screen_bound_seed_plain_matches_jax(nfilt, ignore_model_err):
    """Bounds and anchor seed against `_screen_prep` with B = 70 ragged
    against 32-row blocks and M = 300 against 64-model subtiles: JAX's
    models are padded to whole subtiles with copies of the last sorted
    model, so its last subtile's box is the port's (real models only),
    and its anchors stride over the real models as the port's do."""
    import jax.numpy as jnp

    B, M, sm, tm = 70, 300, 64, 128
    d, de, _, m, me, _, G = fullmask_problem(nfilt, B=B, M=M)
    c0 = nfilt - 2.0
    srt = SC.sort_and_bound(_t(d), _t(de), _t(m.T), _t(me.T), _t(G), sm=sm,
                            tm=tm, tb=SCK.TB,
                            ignore_model_err=ignore_model_err)
    sa = (srt.d, srt.de, srt.mT, srt.meT)
    kw = dict(sm=sm, tm=tm, c0=c0, ignore_model_err=ignore_model_err)
    bounds, bmin, start, seed = SCK.screen_bound_seed_plain(
        *sa, *srt.boxes, **kw)
    anchor = SCK.anchor_seed_plain(*sa, c0, ignore_model_err)
    last = int(SC.locality_sort(_t(d), _t(m.T))[1][-1])
    npad = -(-M // sm) * sm - M
    pad = lambda x: np.concatenate([x, np.repeat(x[last:last + 1], npad,  # noqa: E731
                                                 axis=0)])
    jd, _, _, _, _, jb, js, _ = JF._screen_prep(
        *(jnp.asarray(x) for x in (d, de, pad(m).T, pad(me).T, pad(G))), M,
        sm, SCK.N_ANCHOR, c0, ignore_model_err)
    np.testing.assert_array_equal(to_numpy(srt.d), np.asarray(jd))
    assert bounds.shape == (-(-M // sm), B) == np.asarray(jb).shape
    np.testing.assert_allclose(to_numpy(bounds), np.asarray(jb), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(to_numpy(anchor), np.asarray(js)[0],
                               rtol=1e-6, atol=0)
    # The seed is the anchor seed's min with the home tile's.
    home = SCK._home_seed_plain(*sa, start, width=tm, c0=c0, tb=SCK.TB,
                                ignore_model_err=ignore_model_err)
    _same_bits(seed, torch.minimum(anchor, home))
    assert bool((seed <= anchor).all())
    for x, y in ((bounds, srt.bounds), (bmin, srt.bmin), (start, srt.start),
                 (seed, srt.seed)):
        _same_bits(x, y)


def _earlier_seed_stage(d, de, mT, meT, sm, tm, tb, c0, ignore_model_err):
    """The glue's seed stage before it became one kernel, on sorted
    objects and models: `screen_prep`'s bounds and anchor seed,
    `sort_and_bound`'s bmin and start, the home-tile seed of the one-warp
    kernel's plain version and their torch.minimum, as written there."""
    F, M = mT.shape
    B = d.shape[0]
    S = -(-M // sm)
    pad = S * sm - M
    pad_with = lambda x, v: torch.nn.functional.pad(x, (0, pad), value=v)  # noqa: E731
    blo = pad_with(mT, torch.inf).reshape(F, S, sm).amin(dim=2)
    bhi = pad_with(mT, -torch.inf).reshape(F, S, sm).amax(dim=2)
    memax = pad_with(meT, -torch.inf).reshape(F, S, sm).amax(dim=2)
    bound = None
    for k in range(F):
        dk = d[None, :, k]
        gap = torch.clamp_min(torch.maximum(blo[k][:, None] - dk,
                                            dk - bhi[k][:, None]), 0.0)
        v = de[None, :, k] * de[None, :, k]
        if not ignore_model_err:
            v = v + memax[k][:, None] * memax[k][:, None]
        t = gap * gap / v
        bound = t if bound is None else bound + t
    bound = bound * (1.0 - 1e-4)
    A = min(256, M)
    aidx = torch.arange(A) * (M // A)
    am, ame = mT[:, aidx], meT[:, aidx]
    chi2a = None
    for k in range(F):
        va = de[:, k:k + 1] * de[:, k:k + 1]
        if not ignore_model_err:
            va = va + ame[k][None, :] * ame[k][None, :]
        r = d[:, k:k + 1] - am[k][None, :]
        t = r * r / va
        chi2a = t if chi2a is None else chi2a + t
    qual = chi2a >= c0 * (1.0 + 1e-3)
    anchor = torch.where(qual, chi2a, torch.inf).amin(dim=1) * (1.0 + 1e-4)
    nb = -(-B // tb)
    bmin = torch.nn.functional.pad(bound, (0, nb * tb - B), value=torch.inf)
    bmin = bmin.reshape(S, nb, tb).amin(dim=2)
    start = ((torch.argmin(bmin, dim=0) // (tm // sm)) * tm).to(torch.int32)
    idx = start.long()[:, None] + torch.arange(tm)[None, :]
    safe = idx.clamp_max(M - 1)
    mg, meg = mT[:, safe], meT[:, safe]
    rows = lambda x, fill: torch.cat(  # noqa: E731
        [x, x.new_full((nb * tb - B, F), fill)]).reshape(nb, tb, F)
    d3, de3 = rows(d, 0.0), rows(de, 1.0)
    de2 = de3 * de3
    chi2 = torch.zeros((nb, tb, tm))
    for k in range(F):
        var = de2[..., k:k + 1]
        if not ignore_model_err:
            var = var + meg[k][:, None, :] * meg[k][:, None, :]
        r = d3[..., k:k + 1] - mg[k][:, None, :]
        chi2 = chi2 + (r * r) / var
    keep = (idx < M)[:, None, :] & (chi2 >= c0)
    hi = torch.where(keep, chi2, torch.inf).amin(dim=2).reshape(-1)[:B]
    return bound, bmin, start, torch.minimum(anchor, hi * (1.0 + 1e-6))


@pytest.mark.parametrize("ignore_model_err", [False, True])
@pytest.mark.parametrize("case", ["f1", "f2", "f5_ragged", "f5_edges",
                                  "f20", "locality"])
def test_seed_stage_equals_the_earlier_glue(case, ignore_model_err):
    """`sort_and_bound` (the seed stage's plain version on CPU tensors)
    gives the earlier glue's bounds, bmin, start and seed bit for bit;
    "f5_edges" holds a zero error (0/0 bounds under ignore_model_err:
    NaN), infinite errors (every bound 0: block 0's least bounds tie) and
    an all-clamped row."""
    F, B, M, sm, tm = {"f1": (1, 45, 99, 32, 64),
                       "f2": (2, 31, 700, 128, 256),
                       "f5_ragged": (5, 77, 1003, 128, 512),
                       "f5_edges": (5, 70, 700, 64, 128),
                       "f20": (20, 40, 500, 64, 128),
                       "locality": (5, 64, 4096, 256, 512)}[case]
    if case == "locality":
        d, de, _, m, me, _, G = locality_problem()
    else:
        d, de, _, m, me, _, G = fullmask_problem(F, B=B, M=M)
    if case == "f5_edges":
        d, de = d.copy(), de.copy()
        de[3, 2], d[3, 2] = 0.0, m[0, 2]
        de[0:2] = np.inf
    srt = SC.sort_and_bound(_t(d), _t(de), _t(m.T), _t(me.T), _t(G), sm=sm,
                            tm=tm, tb=SCK.TB,
                            ignore_model_err=ignore_model_err)
    want = _earlier_seed_stage(srt.d, srt.de, srt.mT, srt.meT, sm, tm,
                               SCK.TB, F - 2.0, ignore_model_err)
    for got, w, name in zip((srt.bounds, srt.bmin, srt.start, srt.seed),
                            want, ("bounds", "bmin", "start", "seed")):
        _same_bits(got, w, name)
    if case == "f5_edges" and ignore_model_err:
        assert bool(torch.isnan(srt.bounds).any())


def test_screen_bound_seed_checks_inputs_and_launches_nothing_on_cpu():
    d, de, _, m, me, _, G = fullmask_problem(5, B=40, M=300)
    srt = SC.sort_and_bound(_t(d), _t(de), _t(m.T), _t(me.T), _t(G), sm=64,
                            tm=128, tb=SCK.TB, ignore_model_err=False)
    sa = (srt.d, srt.de, srt.mT, srt.meT)
    kw = dict(sm=64, tm=128, c0=3.0)
    K.reset_launch_counts()
    got = SCK.screen_bound_seed(*sa, *srt.boxes, **kw)
    want = SCK.screen_bound_seed_plain(*sa, *srt.boxes, **kw)
    for g, w in zip(got, want):
        _same_bits(g, w)
    assert got[2].dtype == torch.int32 and got[1].shape == (5, 2)
    assert all(n == 0 for n in K.launch_counts().values())
    blo, bhi, memax = srt.boxes
    for bad, err in (
            (dict(args=(*sa, blo[:, :-1], bhi, memax)), ValueError),
            (dict(args=(*sa, blo, bhi.double(), memax)), TypeError),
            (dict(args=(*sa, blo, bhi, memax.T)), ValueError),
            (dict(kw=dict(kw, tm=96)), ValueError),
            (dict(kw=dict(kw, sm=0)), ValueError),
            (dict(kw=dict(kw, n_anchor=0)), ValueError),
            (dict(args=(sa[0], sa[1], sa[2][:, :0], sa[3][:, :0],
                        blo[:, :0], bhi[:, :0], memax[:, :0])), ValueError)):
        with pytest.raises(err):
            SCK.screen_bound_seed(*bad.get("args", (*sa, *srt.boxes)),
                                  **bad.get("kw", kw))
