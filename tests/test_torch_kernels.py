"""The CUDA kernels' wrappers, plain versions and counters: the
full-mask chi^2 pair (`kernels.fullmask`) and the general lnl kernels
(`kernels.general`), in fixed and free scale, with the one-pass kernel
and the free-scale sweep counts.

This file imports neither JAX nor `frankenz_tpu`, so it also runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels.py

Tests marked `gpu` hold each CUDA kernel against its plain version on
the card and skip without one.  Tolerances there: chi^2 brackets 2e-7
relative; lmap and the top-T values 1 ulp (the kernel and the plain
version round every operation in the same order: expected bit-equal,
up to the last ulp of `log`); tie and pair counts and the free-scale
sweep tables exact; weight sums and PDFs 1e-5 relative, levid 1e-5 of
max(1, |levid|) (the same weights, summed in another order: levid's
absolute error is the sum's relative error).
"""

import numpy as np
import pytest
import torch

from frankenz_tpu_torch import kernels as K
from frankenz_tpu_torch.kernels import fullmask as FM
from frankenz_tpu_torch.kernels import general as GK
from frankenz_tpu_torch.ops import fused as TF
from frankenz_tpu_torch.ops import kde as TK

torch.set_num_threads(1)


def _problem(F, B=19, M=251, Ngrid=77, seed=23):
    rng = np.random.default_rng(seed)
    m = rng.uniform(1, 10, (M, F)).astype(np.float32)
    me = (0.05 * m).astype(np.float32)
    d = (m[rng.integers(0, M, B)]
         + rng.normal(0, 0.3, (B, F))).astype(np.float32)
    d[0] = 1e6  # every chi^2 past the clamp
    de = np.full((B, F), 0.3, np.float32)
    G = TK.kernel_matrix(rng.uniform(0, 3, M), np.full(M, 0.1),
                         np.linspace(0, 3, Ngrid)).to(torch.float32)
    return [torch.from_numpy(x) for x in (d, de, m.T.copy(), me.T.copy())] \
        + [G.contiguous()]


def test_cpu_wrappers_run_plain_versions_without_launching():
    t = _problem(5)
    FM.reset_launch_counts()
    below, above = FM.chi2_brackets(*t[:4], c0=3.0)
    ref = FM.chi2_brackets_plain(*t[:4], c0=3.0)
    shift = torch.zeros(t[0].shape[0])
    pdf, s = FM.chi2_stack(*t, shift, a1=1.5, wthr=1e-3)
    ref_pdf, ref_s = FM.chi2_stack_plain(*t, shift, a1=1.5, wthr=1e-3)
    assert torch.equal(below, ref[0]) and torch.equal(above, ref[1])
    assert torch.equal(pdf, ref_pdf) and torch.equal(s, ref_s)
    assert FM.launch_counts() == {"chi2_brackets": 0, "chi2_stack": 0}
    if not torch.cuda.is_available():
        assert not TF.kernels_available()


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
def test_wrappers_check_their_inputs(bad):
    d, de, mT, meT, _ = _problem(5)
    if bad == "dtype":
        d, err = d.double(), TypeError
    elif bad == "shape":
        de, err = de[:-1], ValueError
    else:
        mT, err = mT.T.contiguous().T, ValueError
    with pytest.raises(err):
        FM.chi2_brackets(d, de, mT, meT, c0=3.0)


def test_brackets_and_weights_follow_the_pallas_definitions():
    """max{chi2 < c0} / min{chi2 >= c0} (-1 / +inf when empty), and the
    weight chain chi2^a1 exp(-chi2/2 - shift) with the clamp below the
    log form and the log form above it."""
    d, de, mT, meT, _ = (x.double().numpy() for x in _problem(5))
    chi2 = ((d[:, None, :] - mT.T[None]) ** 2
            / (de[:, None, :] ** 2 + meT.T[None] ** 2)).sum(-1)
    below, above = (x.numpy() for x in FM.chi2_brackets_plain(
        *_problem(5)[:4], c0=3.0))
    np.testing.assert_allclose(below, np.where(chi2 < 3, chi2, -1).max(1),
                               rtol=1e-5)
    np.testing.assert_allclose(above,
                               np.where(chi2 >= 3, chi2, np.inf).min(1),
                               rtol=1e-5)
    c = torch.tensor([0.5, 3.0, 40.0, 5e4])
    for a1 in (-0.5, 0.0, 1.5, 4.0, 9.0):
        w = FM._weights_plain(c, torch.tensor(0.0), a1).double().numpy()
        cc = c.double().numpy()
        if a1 <= FM.A1_NOLOG_MAX:
            cc = np.minimum(cc, FM.CHI2_CLAMP)
        np.testing.assert_allclose(w, cc ** a1 * np.exp(-0.5 * cc),
                                   rtol=1e-5, atol=1e-300)


GENERAL = ["lnl_reduce", "lnl_reduce_split", "lnl_stack", "lnl_topk",
           "lnl_cut_stack"]


def _general_problem(F=5, B=19, M=251, Ngrid=77, seed=29, masked=True):
    """(d, de, dm, mT, meT, mmT, G): 15% of data bands and 10% of model
    bands masked, rows 1-3 with at most 0, 1 and 2 observed bands (Ndim
    0: a degenerate row; Ndim 2: a1 = 0), models 40-59 duplicating 0-19
    (ties for `lnl_topk`)."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(1, 10, (M, F)).astype(np.float32)
    if M >= 60:
        m[40:60] = m[:20]
    me = (0.05 * m).astype(np.float32)
    d = (m[rng.integers(0, M, B)]
         + rng.normal(0, 0.3, (B, F))).astype(np.float32)
    de = np.full((B, F), 0.3, np.float32)
    dm = np.ones((B, F), np.float32)
    mm = np.ones((M, F), np.float32)
    if masked:
        dm = (rng.uniform(size=(B, F)) > 0.15).astype(np.float32)
        mm = (rng.uniform(size=(M, F)) > 0.1).astype(np.float32)
        if M >= 60:
            mm[40:60] = mm[:20]
        dm[1:4] = 0.0
        dm[2, 0] = dm[3, :2] = 1.0
    G = TK.kernel_matrix(rng.uniform(0, 3, M), np.full(M, 0.1),
                         np.linspace(0, 3, Ngrid)).to(torch.float32)
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in (d, de, dm, m.T, me.T, mm.T)] + [G.contiguous()]


def _general_call(name, t, plain=False, bad=None, **flags):
    """Call a general wrapper (or its plain version) on problem `t`; the
    per-object rows it reads come from the plain versions.  `bad`
    replaces the kernel inputs (d .. mmT) for the call itself."""
    args = t[:6]
    fn = getattr(GK, name + "_plain" if plain else name)
    call = bad if bad is not None else args
    if name == "lnl_reduce":
        return fn(*call, **flags)
    if name == "lnl_onepass":
        return fn(*call, t[6], **flags)
    if name == "lnl_topk":
        return fn(*call, T=8, **flags)
    lmap, levid = GK.lnl_reduce_plain(*args, **flags)
    if name == "lnl_reduce_split":
        # Rows 0-3 put every pair at or below the split, the rest split
        # at 3 below lmap.
        split = torch.where(torch.arange(len(lmap), device=lmap.device) < 4,
                            torch.inf, lmap - 3.0)
        return fn(*call, split, **flags)
    if name == "lnl_stack":
        return (fn(*call, t[6], lmap, levid, log_thr=float(np.log(1e-3)),
                   **flags),)
    vals, cnts = GK.lnl_topk_plain(*args, T=8, **flags)
    cut, tie, nkeep, _ = TF.cdf_cut(vals, cnts, levid, 2e-4)
    return (fn(*call, t[6], cut, levid, tie, nkeep, **flags),)


@pytest.mark.parametrize("name", GENERAL)
def test_cpu_general_wrappers_run_plain_versions_without_launching(name):
    t = _general_problem()
    K.reset_launch_counts()
    got = _general_call(name, t)
    want = _general_call(name, t, plain=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(n == 0 for n in K.launch_counts().values())
    assert set(K.launch_counts()) == {"chi2_brackets", "chi2_stack", *GENERAL,
                                      "lnl_onepass", "scale_sweeps"}


def _free_flags(t, ignore_model_err, tm=96, **flags):
    """Free-scale flags for problem `t`: with model errors, the plain
    sweep table at group width `tm` (ragged against M)."""
    flags = dict(flags, free_scale=True, ignore_model_err=ignore_model_err)
    if not ignore_model_err:
        flags.update(tm=tm, sweeps=GK.scale_sweeps_plain(
            *t[:6], tm=tm, full_mask=flags.get("full_mask", False)))
    return flags


@pytest.mark.parametrize("ignore_model_err", [True, False])
@pytest.mark.parametrize("name", GENERAL + ["lnl_onepass"])
def test_cpu_free_scale_wrappers_run_plain_versions_without_launching(
        name, ignore_model_err):
    t = _general_problem()
    flags = _free_flags(t, ignore_model_err)
    K.reset_launch_counts()
    got = _general_call(name, t, **flags)
    want = _general_call(name, t, plain=True, **flags)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(n == 0 for n in K.launch_counts().values())


def test_sweep_tables_are_checked():
    """The table is int16 (B, ceil(M / tm)), given exactly under free
    scale with model errors."""
    t = _general_problem()
    flags = _free_flags(t, False)
    sw = flags.pop("sweeps")
    for bad, err in ((sw.int(), TypeError), (sw[:, :-1], ValueError),
                     (None, ValueError)):
        with pytest.raises(err):
            GK.lnl_reduce(*t[:6], sweeps=bad, **flags)
    with pytest.raises(ValueError, match="only under free scale"):
        GK.lnl_reduce(*t[:6], sweeps=sw)
    assert sw.dtype == torch.int16 and sw.shape == (19, 3)


def test_lnl_tile_plain_free_scale_follows_the_definitions():
    """Free scale, datum-only variance: s = (sum mask m d / de^2) / (sum
    mask m^2 / de^2), chi2 = sum mask (d - s m)^2 / de^2 floored at
    16 eps A, the dim prior with dof = Ndim - 1 (float32 min below 2
    bands).  With model errors and k sweeps per pair: s_0 from var =
    de^2 + me^2, s_i from var = de^2 + (s_{i-1} me)^2, chi2 with
    var(s_{k-1}) and s_k."""
    from scipy.special import gammaln

    t = _general_problem()
    d, de, dm, mT, meT, mmT = (x.double().numpy()[:, :, None] if i < 3
                               else x.double().numpy().T[None]
                               for i, x in enumerate(t[:6]))
    d, de, dm = (x.transpose(0, 2, 1) for x in (d, de, dm))
    mask = dm * mmT
    nd = mask.sum(-1)

    def scale(var):
        return ((mask * mT * d / var).sum(-1)
                / np.maximum((mask * mT ** 2 / var).sum(-1), 1e-30))

    def lnl_of(chi2, A):
        chi2 = np.maximum(chi2, GK.CHI2_NOISE * A)
        a = 0.5 * (nd - 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = (np.where(a == 1.0, 0.0, (a - 1) * np.log(chi2))
                   - 0.5 * chi2 - gammaln(a) - a * np.log(2.0))
        return np.where(nd >= 2, out, GK.NEG_INF)

    var = de ** 2
    s = scale(var)
    chi2 = (mask * (d - s[..., None] * mT) ** 2 / var).sum(-1)
    want = lnl_of(chi2, (mask * d ** 2 / var).sum(-1))
    got = GK.lnl_tile_plain(*t[:6], free_scale=True,
                            ignore_model_err=True).double().numpy()
    assert (nd[1] == 0).all() and (nd[2] <= 1).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    flags = _free_flags(t, False)
    k = flags["sweeps"].numpy()[:, np.arange(mT.shape[-2]) // flags["tm"]]
    s = scale(de ** 2 + meT ** 2)
    prev = s
    for i in range(1, int(k.max()) + 1):
        s_n = scale(de ** 2 + (s[..., None] * meT) ** 2)
        prev, s = np.where(k >= i, s, prev), np.where(k >= i, s_n, s)
    var = de ** 2 + (prev[..., None] * meT) ** 2
    chi2 = (mask * (d - s[..., None] * mT) ** 2 / var).sum(-1)
    want = lnl_of(chi2, (mask * d ** 2 / var).sum(-1))
    got = GK.lnl_tile_plain(*t[:6], **flags).double().numpy()
    assert k.min() >= 1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
@pytest.mark.parametrize("name", GENERAL)
def test_general_wrappers_check_their_inputs(name, bad):
    t = _general_problem()
    call = list(t[:6])
    if bad == "dtype":
        call[2], err = call[2].double(), TypeError
    elif bad == "shape":
        call[2], err = call[2][:-1], ValueError
    else:
        call[5], err = call[5].T.contiguous().T, ValueError
    with pytest.raises(err):
        _general_call(name, t, bad=call)


def test_lnl_reduce_split_plain_follows_its_definition():
    """log-sum-exp over the pairs with lnl > split[b], over those with
    lnl <= split[b], and the count of the first; -inf for an empty side;
    the two sides add up to `lnl_reduce`'s levid."""
    from scipy.special import logsumexp

    t = _general_problem()
    lnl = GK.lnl_tile_plain(*t[:6]).double().numpy()
    lmap, levid = GK.lnl_reduce_plain(*t[:6])
    split = (lmap - 2.0).numpy()
    split[5] = np.inf
    gt, le, n = (x.numpy() for x in GK.lnl_reduce_split_plain(
        *t[:6], torch.from_numpy(split)))
    above = lnl > split[:, None]
    np.testing.assert_array_equal(n, above.sum(1))
    assert n[5] == 0 and gt[5] == -np.inf
    with np.errstate(divide="ignore"):
        want_gt = logsumexp(np.where(above, lnl, -np.inf), axis=1)
        want_le = logsumexp(np.where(above, -np.inf, lnl), axis=1)
    np.testing.assert_allclose(gt, want_gt, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(le, want_le, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.logaddexp(gt, le), levid.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_lnl_tile_plain_follows_the_likelihood_definitions():
    """Dim prior: (Ndim/2 - 1) log chi2 - chi2/2 - gammaln(Ndim/2) -
    (Ndim/2) ln 2, no log term at Ndim 2 and the float32-min floor at
    Ndim 0; Normal: -chi2/2 - (Ndim log 2 pi + sum_all log var)/2."""
    from scipy.special import gammaln

    t = _general_problem()
    d, de, dm, mT, meT, mmT = (x.double().numpy() for x in t[:6])
    var = de[:, None, :] ** 2 + meT.T[None] ** 2
    mask = dm[:, None, :] * mmT.T[None]
    chi2 = (mask * (d[:, None, :] - mT.T[None]) ** 2 / var).sum(-1)
    nd = mask.sum(-1)
    a = 0.5 * nd
    with np.errstate(divide="ignore", invalid="ignore"):
        want = np.where(nd == 2, 0.0, (a - 1) * np.log(chi2)) \
            - 0.5 * chi2 - gammaln(a) - a * np.log(2.0)
    want = np.where(nd > 0, want, GK.NEG_INF)
    got = GK.lnl_tile_plain(*t[:6]).double().numpy()
    assert (nd[1] == 0).all() and (nd[2] <= 1).all() and (nd[3] == 2).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    want_n = (-0.5 * chi2 - 0.5 * (nd * np.log(2 * np.pi)
                                   + np.log(var).sum(-1)))
    got_n = GK.lnl_tile_plain(*t[:6], dim_prior=False).double().numpy()
    np.testing.assert_allclose(got_n, want_n, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------


def _assert_within_ulp(got, want):
    """Infinities in the same places, finite entries within one float32
    ulp of `want`."""
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin], want[~fin])
    w = want[fin]
    ulp = torch.nextafter(w.abs(), torch.full_like(w, torch.inf)) - w.abs()
    assert bool(((got[fin] - w).abs() <= ulp).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("nfilt,B,M,Ngrid", [(5, 19, 251, 77),
                                              (2, 40, 1000, 513),
                                              (20, 33, 700, 301),
                                              (5, 70, 3000, 4001)])
def test_kernels_match_plain_on_card(cuda_device, nfilt, B, M, Ngrid):
    t = [x.to(cuda_device) for x in _problem(nfilt, B=B, M=M, Ngrid=Ngrid)]
    a1 = 0.5 * nfilt - 1.0
    FM.reset_launch_counts()
    got = FM.chi2_brackets(*t[:4], c0=2 * a1)
    want = FM.chi2_brackets_plain(*t[:4], c0=2 * a1)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-7, atol=0)
    lmap, shift = TF.lmap_and_shift(*want, nfilt)
    got = FM.chi2_stack(*t, shift, a1=a1, wthr=1e-3)
    want = FM.chi2_stack_plain(*t, shift, a1=a1, wthr=1e-3)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    scale = want[0].abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    torch.testing.assert_close(got[0] / scale, want[0] / scale, rtol=0,
                               atol=1e-5)
    assert FM.launch_counts() == {"chi2_brackets": 1, "chi2_stack": 1}


@pytest.mark.gpu
def test_fused_on_card_matches_cpu_route(cuda_device):
    t = _problem(5)
    d, de, m, me, G = t[0], t[1], t[2].T, t[3].T, t[4]
    ones = torch.ones_like(d), torch.ones_like(m)
    cpu = TF.fused_fit_pdf(d, de, ones[0], m, me, ones[1], G)
    dev = TF.fused_fit_pdf(*(x.to(cuda_device) for x in (
        d, de, ones[0], m, me, ones[1], G)))
    torch.testing.assert_close(dev[0].cpu(), cpu[0], rtol=2e-3, atol=2e-5)
    for g, w in zip(dev[1:], cpu[1:]):
        torch.testing.assert_close(g.cpu(), w, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_bruteforce_on_card_matches_cpu_and_counts_launches(cuda_device):
    from frankenz_tpu_torch.models import BruteForce

    rng = np.random.default_rng(8)
    M, B, F = 1500, 200, 5
    m = rng.uniform(1, 10, (M, F)).astype(np.float32)
    args = ((m[rng.integers(0, M, B)] + rng.normal(0, 0.25, (B, F))).astype(
        np.float32), np.full((B, F), 0.25, np.float32),
        np.ones((B, F), np.float32), rng.uniform(0, 3, M), np.full(M, 0.1))
    kw = dict(label_grid=np.linspace(0, 3, 101), verbose=False,
              return_gof=True)
    models = (m, (0.05 * m).astype(np.float32), np.ones_like(m))
    cpu = BruteForce(*models, device="cpu").fit_predict(*args, **kw)
    gpu_bf = BruteForce(*models, device="cuda")
    FM.reset_launch_counts()
    gpu = gpu_bf.fit_predict(*args, **kw)
    assert all(n > 0 for n in FM.launch_counts().values())
    np.testing.assert_allclose(gpu[1][0], cpu[1][0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gpu[1][1], cpu[1][1], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=2e-3, atol=2e-5)
    masked = args[2].copy()
    masked[::3, 0] = 0.0
    margs = (args[0], args[1], masked, *args[3:])
    cpu = BruteForce(*models, device="cpu").fit_predict(*margs, **kw)
    K.reset_launch_counts()
    gpu = gpu_bf.fit_predict(*margs, **kw)
    counts = K.launch_counts()
    assert counts["lnl_reduce"] > 0 and counts["lnl_stack"] > 0
    assert counts["chi2_brackets"] == counts["chi2_stack"] == 0
    np.testing.assert_allclose(gpu[1][0], cpu[1][0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gpu[1][1], cpu[1][1], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=2e-3, atol=2e-5)
    # Free scale with model errors, and no weight threshold: the sweep
    # counts, then the free-scale and one-pass kernels.
    for lkw, extra, names in (
            (dict(free_scale=True), {}, ("scale_sweeps", "lnl_reduce",
                                         "lnl_stack")),
            ({}, dict(wt_thresh=None, cdf_thresh=None), ("lnl_onepass",))):
        fkw = dict(kw, lprob_kwargs=lkw, **extra)
        cpu = BruteForce(*models, device="cpu").fit_predict(*margs, **fkw)
        K.reset_launch_counts()
        gpu = gpu_bf.fit_predict(*margs, **fkw)
        counts = K.launch_counts()
        assert all(counts[n] > 0 for n in names), counts
        for k in (0, 1):
            np.testing.assert_allclose(gpu[1][k], cpu[1][k], rtol=2e-5,
                                       atol=2e-5)
        np.testing.assert_allclose(gpu[0], cpu[0], rtol=2e-3, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("flags,F,B,M,Ngrid", [
    (dict(), 5, 19, 251, 77),
    (dict(ignore_model_err=True), 5, 40, 1000, 513),
    (dict(dim_prior=False), 5, 70, 3000, 4001),
    (dict(full_mask=True, dim_prior=False), 5, 33, 700, 301),
    (dict(full_mask=True), 8, 33, 700, 301),
    (dict(), 20, 33, 700, 301),
])
def test_general_kernels_match_plain_on_card(cuda_device, flags, F, B, M,
                                             Ngrid):
    t = [x.to(cuda_device) for x in _general_problem(
        F, B=B, M=M, Ngrid=Ngrid, masked=not flags.get("full_mask"))]
    K.reset_launch_counts()
    for name in GENERAL:
        got = _general_call(name, t, **flags)
        want = _general_call(name, t, plain=True, **flags)
        torch.cuda.synchronize()
        if name == "lnl_reduce":
            _assert_within_ulp(got[0], want[0])
            torch.testing.assert_close(got[1], want[1], rtol=1e-5,
                                       atol=1e-5)
        elif name == "lnl_reduce_split":
            for g, w in zip(got[:2], want[:2]):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
            assert torch.equal(got[2], want[2])
        elif name == "lnl_topk":
            _assert_within_ulp(got[0], want[0])
            assert torch.equal(got[1], want[1])
        else:
            scale = want[0].abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
            torch.testing.assert_close(got[0] / scale, want[0] / scale,
                                       rtol=0, atol=1e-5)
    counts = K.launch_counts()
    assert all(counts[name] == 1 for name in GENERAL)
    assert counts["chi2_brackets"] == counts["chi2_stack"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("ignore_model_err", [True, False])
@pytest.mark.parametrize("flags,F,B,M,Ngrid", [
    (dict(), 5, 19, 251, 77),
    (dict(dim_prior=False), 5, 70, 3000, 513),
    (dict(full_mask=True), 5, 33, 700, 301),
    (dict(full_mask=True, dim_prior=False), 8, 33, 700, 301),
    (dict(), 20, 33, 700, 301),
])
def test_free_scale_kernels_match_plain_on_card(cuda_device, flags, F, B, M,
                                                Ngrid, ignore_model_err):
    """Every free-scale entry point, the one-pass kernel and the sweep
    counts against their plain versions; the consumers read the plain
    table, which the kernel's equals."""
    t = [x.to(cuda_device) for x in _general_problem(
        F, B=B, M=M, Ngrid=Ngrid, masked=not flags.get("full_mask"))]
    flags = _free_flags(t, ignore_model_err, **flags)
    K.reset_launch_counts()
    if not ignore_model_err:
        got = GK.scale_sweeps(*t[:6], tm=flags["tm"],
                              full_mask=flags.get("full_mask", False))
        assert torch.equal(got, flags["sweeps"])
    for name in GENERAL + ["lnl_onepass"]:
        got = _general_call(name, t, **flags)
        want = _general_call(name, t, plain=True, **flags)
        torch.cuda.synchronize()
        if name in ("lnl_reduce", "lnl_onepass"):
            k = 1 if name == "lnl_onepass" else 0
            _assert_within_ulp(got[k], want[k])
            torch.testing.assert_close(got[k + 1], want[k + 1], rtol=1e-5,
                                       atol=1e-5)
            if name == "lnl_reduce":
                continue
        if name == "lnl_reduce_split":
            for g, w in zip(got[:2], want[:2]):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
            assert torch.equal(got[2], want[2])
        elif name == "lnl_topk":
            _assert_within_ulp(got[0], want[0])
            assert torch.equal(got[1], want[1])
        else:
            scale = want[0].abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
            torch.testing.assert_close(got[0] / scale, want[0] / scale,
                                       rtol=0, atol=1e-5)
    counts = K.launch_counts()
    assert all(counts[name] == 1 for name in GENERAL + ["lnl_onepass"])
    assert counts["scale_sweeps"] == (0 if ignore_model_err else 1)


@pytest.mark.gpu
@pytest.mark.parametrize("flags,F,B,M,Ngrid", [
    (dict(), 5, 19, 251, 77),
    (dict(dim_prior=False), 5, 70, 3000, 4001),
    (dict(full_mask=True, dim_prior=False), 5, 33, 700, 301),
    (dict(full_mask=True), 20, 33, 700, 301),
])
def test_onepass_matches_plain_on_card(cuda_device, flags, F, B, M, Ngrid):
    """Fixed-scale `lnl_onepass`: lmap within 1 ulp, levid 1e-5, PDFs
    row-normwise 1e-5 (Ngrid 4001: several column chunks per row)."""
    t = [x.to(cuda_device) for x in _general_problem(
        F, B=B, M=M, Ngrid=Ngrid, masked=not flags.get("full_mask"))]
    GK.reset_launch_counts()
    got = _general_call("lnl_onepass", t, **flags)
    want = _general_call("lnl_onepass", t, plain=True, **flags)
    torch.cuda.synchronize()
    _assert_within_ulp(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)
    scale = want[0].abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    torch.testing.assert_close(got[0] / scale, want[0] / scale, rtol=0,
                               atol=1e-5)
    assert GK.launch_counts()["lnl_onepass"] == 1
