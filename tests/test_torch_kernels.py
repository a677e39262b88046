"""The CUDA kernels' wrappers, plain versions and counters: the
full-mask chi^2 pair (`kernels.fullmask`), the screened full-mask trio
(`kernels.screened`), the general lnl kernels
(`kernels.general`), in fixed and free scale, with the one-pass kernel
and the free-scale sweep counts, the SOM training run (`kernels.som`), the
GNG training run (`kernels.gng`) and the population chain (`kernels.pop`).

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
absolute error is the sum's relative error); the screened seed and
brackets 1 ulp (expected bit-equal), the screened route against its
run-all twin and the screened lmap against the pair's bit for bit; `som_train` the same best
node at every step and nodes within 1e-6 relative (expected bit-equal:
the same operations in the same order); `gng_train` every state array
bit for bit (the same operations in the same order); `pop_chain` samples,
lnpost and the carry bit for bit (one differing ulp in a log-sum could
flip an accept, after which the chains part for good).  The two chain
kernels' cluster routes are held against their block routes and plain
versions bit for bit at every cluster size (`cluster=`) the card
schedules; on the CPU the route choice and the split identities of
`tree_sum` are checked in plain Python.
"""

import numpy as np
import pytest
import torch

from frankenz_tpu_torch import kernels as K
from frankenz_tpu_torch.kernels import fullmask as FM
from frankenz_tpu_torch.kernels import general as GK
from frankenz_tpu_torch.kernels import gng as GG
from frankenz_tpu_torch.kernels import pop as PK
from frankenz_tpu_torch.kernels import screened as SCK
from frankenz_tpu_torch.kernels import som as SK
from frankenz_tpu_torch.ops import fused as TF
from frankenz_tpu_torch.ops import kde as TK
from frankenz_tpu_torch.ops import screen as SC

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
                         np.linspace(0, 3, Ngrid), device="cpu").to(
                             torch.float32)
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
           "lnl_reduce_topk", "lnl_cut_stack"]


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
                         np.linspace(0, 3, Ngrid), device="cpu").to(
                             torch.float32)
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in (d, de, dm, m.T, me.T, mm.T)] + [G.contiguous()]


def _general_call(name, t, plain=False, bad=None, **flags):
    """Call a general wrapper (or its plain version) on problem `t`; the
    per-object rows it reads come from the plain versions.  `bad`
    replaces the kernel inputs (d .. mmT) for the call itself.  The band
    stacks (`lnl_onepass`, `lnl_cut_stack`) take the models in band order
    (`band_sort` of the call's model arrays)."""
    args = t[:6]
    fn = getattr(GK, name + "_plain" if plain else name)
    call = bad if bad is not None else args
    bs = None
    if name in ("lnl_onepass", "lnl_cut_stack"):
        bs = GK.band_sort(t[6], *args[3:6])
        if bad is not None:
            bs = bs._replace(mT=call[3], meT=call[4], mmT=call[5])
    if name == "lnl_reduce":
        return fn(*call, **flags)
    if name == "lnl_onepass":
        return fn(*call[:3], bs, **flags)
    if name in ("lnl_topk", "lnl_reduce_topk"):
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
    return (fn(*call[:3], bs, cut, levid, tie, nkeep, **flags),)


@pytest.mark.parametrize("name", GENERAL)
def test_cpu_general_wrappers_run_plain_versions_without_launching(name):
    t = _general_problem()
    K.reset_launch_counts()
    got = _general_call(name, t)
    want = _general_call(name, t, plain=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(n == 0 for n in K.launch_counts().values())
    assert set(K.launch_counts()) == {"chi2_brackets", "chi2_stack",
                                      "screen_seed", "chi2_brackets_screened",
                                      "chi2_stack_screened", *GENERAL,
                                      "lnl_onepass", "scale_sweeps",
                                      "lnl_stack_band",
                                      "lnl_reduce_table", "lnl_stack_table",
                                      "scale_sweeps_table",
                                      "som_train", "som_train_cluster",
                                      "gng_train",
                                      "gng_train_cluster", "pop_chain",
                                      "pop_chain_cluster"}


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


def _assert_reduce_topk(got, want, t, flags):
    """`lnl_reduce_topk` on the card against its plain version (lmap and
    the top-T values 1 ulp, levid 1e-5, counts exact) and its lmap and
    levid against the `lnl_reduce` kernel's bit for bit."""
    _assert_within_ulp(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    _assert_within_ulp(got[2], want[2])
    assert torch.equal(got[3], want[3])
    lmap, levid = GK.lnl_reduce(*t[:6], **flags)
    assert torch.equal(got[0], lmap) and torch.equal(got[1], levid)


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
    K.reset_launch_counts()
    gpu = gpu_bf.fit_predict(*args, **kw)
    # Full masks take the screened trio (K2), as in JAX; not the pair.
    assert all(n > 0 for n in SCK.launch_counts().values())
    assert all(n == 0 for n in FM.launch_counts().values())
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
    # Masked photometry under wt_thresh: the table route in band order.
    assert counts["lnl_reduce"] > 0 and counts["lnl_stack_band"] > 0
    assert counts["lnl_stack"] == 0
    assert counts["chi2_brackets"] == counts["chi2_stack"] == 0
    assert all(counts[n] == 0 for n in SCK.launch_counts())
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
        elif name == "lnl_reduce_topk":
            _assert_reduce_topk(got, want, t, flags)
        else:
            scale = want[0].abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
            torch.testing.assert_close(got[0] / scale, want[0] / scale,
                                       rtol=0, atol=1e-5)
    counts = K.launch_counts()
    # lnl_reduce: its own case and the check of lnl_reduce_topk's bits.
    assert all(counts[name] == (2 if name == "lnl_reduce" else 1)
               for name in GENERAL)
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
        elif name == "lnl_reduce_topk":
            _assert_reduce_topk(got, want, t, flags)
        else:
            scale = want[0].abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
            torch.testing.assert_close(got[0] / scale, want[0] / scale,
                                       rtol=0, atol=1e-5)
    counts = K.launch_counts()
    assert all(counts[name] == (2 if name == "lnl_reduce" else 1)
               for name in GENERAL + ["lnl_onepass"])
    assert counts["scale_sweeps"] == (0 if ignore_model_err else 1)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2, 8, 40])
@pytest.mark.parametrize("flags,F,B,M", [
    (dict(), 5, 19, 251),
    (dict(), 5, 300, 1_000),
    (dict(dim_prior=False), 5, 130, 3_001),
    (dict(full_mask=True), 20, 33, 700),
    (dict(free_scale=True, ignore_model_err=True), 5, 70, 999),
    (dict(free_scale=True), 5, 45, 700),
])
def test_reduce_topk_equals_reduce_and_topk_on_card(cuda_device, flags, F,
                                                     B, M, T):
    """The cdf mode's one walk: lmap and levid bit for bit the
    `lnl_reduce` kernel's, the top-T table that of the plain version
    (values 1 ulp, counts exact; models 40-59 duplicate 0-19, so values
    tie), and `lnl_topk` on the card the same table bit for bit (it
    launches this kernel).  Ragged B and M against the blocks and tiles;
    F = 20 takes the runtime filter loop, F = 5 the compile-time one."""
    t = [x.to(cuda_device) for x in _general_problem(
        F, B=B, M=M, masked=not flags.get("full_mask"))]
    if flags.get("free_scale") and not flags.get("ignore_model_err"):
        flags = _free_flags(t, False, **flags)
    K.reset_launch_counts()
    got = GK.lnl_reduce_topk(*t[:6], T=T, **flags)
    want = GK.lnl_reduce_topk_plain(*t[:6], T=T, **flags)
    topk = GK.lnl_topk(*t[:6], T=T, **flags)
    torch.cuda.synchronize()
    _assert_reduce_topk(got, want, t, flags)
    assert torch.equal(topk[0], got[2]) and torch.equal(topk[1], got[3])
    counts = K.launch_counts()
    assert counts["lnl_reduce_topk"] == counts["lnl_topk"] == 1


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


def _band_case(t, flags, shuffle_seed=None):
    """The band stacks' inputs on problem `t`: the band order of its G
    (its rows shuffled first when `shuffle_seed` is given, so the band
    order is far from the caller's) and a cut on every row just below the
    lnl of model 0, which model 40 duplicates: the group {0, 40, ...}
    straddles it and keeps one member.  Returns (G, bs, (cut, levid, tie,
    nkeep), rows with a straddling group)."""
    G = t[6]
    if shuffle_seed is not None:
        order = np.random.default_rng(shuffle_seed).permutation(G.shape[0])
        G = G[torch.as_tensor(order, device=G.device)].contiguous()
    bs = GK.band_sort(G, *t[3:6])
    _, levid = GK.lnl_reduce_plain(*t[:6], **flags)
    tie = GK.lnl_tile_plain(*t[:6], **flags)[:, 0].contiguous()
    split = tie > GK.NEG_INF
    cut = torch.nextafter(tie, torch.full_like(tie, -torch.inf))
    nkeep = split.to(torch.float32)
    return G, bs, (cut, levid, torch.where(split, tie, torch.inf), nkeep), \
        int(split.sum())


def test_band_sort_orders_by_support_centre():
    """`band_sort`: a stable sort by lo + hi of each G row's nonzero
    columns, all-zero rows last; `inv` inverts `perm`; the model arrays
    and G (padded to 64-row tiles and 4 columns with zeros) follow; each
    tile's band is the exact nonzero hull of its rows; `width` the widest
    band rounded out to 4 columns."""
    t = _general_problem(B=5, M=251, Ngrid=77)
    G = t[6].clone()
    G[7] = 0.0
    bs = GK.band_sort(G, *t[3:6])
    nz = G != 0
    cols = torch.arange(77)
    lo = torch.where(nz, cols, 77).amin(1)
    hi = torch.where(nz, cols, -1).amax(1)
    key = torch.where(hi >= 0, lo + hi, 1000)
    perm = bs.perm.long()
    assert torch.equal(perm, torch.sort(key, stable=True).indices)
    assert int(perm[-1]) == 7
    assert torch.equal(bs.inv.long()[perm], torch.arange(251))
    assert torch.equal(bs.mT, t[3][:, perm])
    assert bs.G.shape == (256, 80) and torch.equal(bs.G[:251, :77], G[perm])
    assert not bs.G[251:].any() and not bs.G[:, 77:].any()
    for k, (a, b) in enumerate(bs.bands.tolist()):
        c = torch.nonzero(bs.G[64 * k:64 * k + 64].any(0)).flatten()
        assert (a, b) == ((int(c[0]), int(c[-1]) + 1) if c.numel()
                          else (0, 0))
    assert bs.width == max(((b + 3) // 4 - a // 4) * 4
                           for a, b in bs.bands.tolist())


@pytest.mark.parametrize("free", [False, True])
def test_band_stacks_plain_equal_caller_order_products(free):
    """The band stacks' plain versions against the caller-order products
    of the same weights, rows shuffled so the band order is far from the
    caller's; the straddling groups keep their first member in the
    caller's order."""
    t = _general_problem(M=700, Ngrid=301)
    flags = _free_flags(t, False) if free else {}
    G, bs, (cut, levid, tie, nkeep), nsplit = _band_case(t, flags, 4)
    assert nsplit > 0
    lnl = GK.lnl_tile_plain(*t[:6], **flags)
    is_tie = lnl == tie[:, None]
    rank = torch.cumsum(is_tie.to(torch.int32), dim=1) - 1
    keep = (lnl <= cut[:, None]) | (is_tie & (rank < nkeep[:, None]))
    w = torch.where(keep, torch.exp(lnl - levid[:, None]), 0.0)
    got = GK.lnl_cut_stack(*t[:3], bs, cut, levid, tie, nkeep, **flags)
    np.testing.assert_allclose(got.double().numpy(),
                               (w.double() @ G.double()).numpy(),
                               rtol=1e-5, atol=1e-9)
    pdf, lmap, _ = GK.lnl_onepass(*t[:3], bs, **flags)
    assert torch.equal(lmap, lnl.amax(1))
    want = torch.exp(lnl - lmap[:, None]).double() @ G.double()
    np.testing.assert_allclose(pdf.double().numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize("free", [False, True])
@pytest.mark.parametrize("flags,F,B,M,Ngrid", [
    (dict(), 5, 70, 3000, 301),
    (dict(dim_prior=False), 5, 33, 700, 1030),
    (dict(full_mask=True), 5, 40, 1000, 4001),
    (dict(ignore_model_err=True), 20, 33, 700, 77),
])
def test_band_stacks_match_plain_on_card(cuda_device, flags, F, B, M, Ngrid,
                                         free):
    """`lnl_onepass` and `lnl_cut_stack` over a shuffled G's band order,
    with straddling tie groups forced on the rows whose top value ties:
    lmap within 1 ulp, levid 1e-5, PDFs row-normwise 1e-5 (Ngrid 1030 and
    4001: several column windows a row)."""
    t = [x.to(cuda_device) for x in _general_problem(
        F, B=B, M=M, Ngrid=Ngrid, masked=not flags.get("full_mask"))]
    if free:
        flags = _free_flags(t, flags.get("ignore_model_err", False),
                            **{k: v for k, v in flags.items()
                               if k != "ignore_model_err"})
    _, bs, rows, nsplit = _band_case(t, flags, 9)
    assert nsplit > 0
    GK.reset_launch_counts()
    got = GK.lnl_cut_stack(*t[:3], bs, *rows, **flags)
    want = GK.lnl_cut_stack_plain(*t[:3], bs, *rows, **flags)
    torch.cuda.synchronize()
    scale = want.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=1e-5)
    got = GK.lnl_onepass(*t[:3], bs, **flags)
    want = GK.lnl_onepass_plain(*t[:3], bs, **flags)
    torch.cuda.synchronize()
    _assert_within_ulp(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)
    scale = want[0].abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    torch.testing.assert_close(got[0] / scale, want[0] / scale, rtol=0,
                               atol=1e-5)
    counts = GK.launch_counts()
    assert counts["lnl_cut_stack"] == counts["lnl_onepass"] == 1


def _band_table_case(t, G, **flags):
    """The table route's inputs on problem `t` with kernel matrix `G`, in
    band order: (band-ordered problem with G's first M rows and Ngrid
    columns, bs, table, lmap, levid) from the producer `lnl_reduce`."""
    bs = GK.band_sort(G, *t[3:6])
    M = t[3].shape[1]
    tb = t[:3] + [bs.mT, bs.meT, bs.mmT, bs.G[:M, :bs.ngrid].contiguous()]
    table = torch.full((t[0].shape[0], GK.table_width(M)), torch.nan,
                       device=G.device)
    lmap, levid = GK.lnl_reduce(*tb[:6], table=table, **flags)
    return tb, bs, table, lmap, levid


def _grid_problem(M, Ngrid):
    """`_general_problem` at M models and Ngrid grid points (one point:
    a column of U(0.1, 1) entries)."""
    t = _general_problem(M=M, Ngrid=max(Ngrid, 2))
    if Ngrid == 1:
        t[6] = torch.from_numpy(np.random.default_rng(4).uniform(
            0.1, 1.0, (M, 1)).astype(np.float32))
    return t


def _zero_tile_signed(G, signed):
    """G with its last 71 rows zero (in band order the last 64-model tile
    of M = 251 is all zero, its band empty) and, when `signed`, every
    seventh row negated and every eleventh from the third at -0.0."""
    G = G.clone()
    G[-71:] = 0.0
    if signed:
        G[::7] *= -1.0
        G[3::11] = -0.0
    return G


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("Ngrid", [1, 77, 301, 513])
def test_band_reader_plain_equals_dense_products_in_band_order(Ngrid,
                                                               signed):
    """`lnl_stack_band`'s plain version (tile by tile over the bands)
    equals `lnl_stack_plain` (every column) on the band-ordered models
    and G bit for bit: ragged M = 251, an all-zero last tile, a signed G
    with -0.0 rows; and the float64 product of the same weights."""
    t = _grid_problem(251, Ngrid)
    G = _zero_tile_signed(t[6], signed)
    tb, bs, table, lmap, levid = _band_table_case(t, G)
    assert bs.bands[-1].tolist() == [0, 0]
    if Ngrid >= 77:
        assert bs.width < Ngrid
    log_thr = float(np.log(1e-3))
    K.reset_launch_counts()
    got = GK.lnl_stack_band(table, bs, lmap, levid, log_thr=log_thr)
    assert torch.equal(got, GK.lnl_stack_band_plain(table, bs, lmap, levid,
                                                    log_thr=log_thr))
    want = GK.lnl_stack_plain(*tb[:6], tb[6], lmap, levid, log_thr=log_thr)
    assert torch.equal(got, want)
    assert (got != 0).any()
    assert all(n == 0 for n in K.launch_counts().values())
    lnl = table[:, :251].double()
    thr = lmap.double() + float(np.float32(log_thr))
    w = torch.where(lnl > thr[:, None], torch.exp(lnl - levid.double()[:,
                                                                     None]),
                    0.0)
    np.testing.assert_allclose(got.numpy(), (w @ tb[6].double()).numpy(),
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("Ngrid", [1, 77, 301, 513])
def test_stack_tiles_band_windows_equal_every_column(Ngrid):
    """`general.stack_tiles` over each tile's band window equals the
    same sum over every column bit for bit (signed G, an all-zero tile,
    ragged M), and a float64 product to float32 roundoff."""
    t = _grid_problem(251, Ngrid)
    bs = GK.band_sort(_zero_tile_signed(t[6], True), *t[3:6])
    w = torch.rand((19, 251), generator=torch.Generator().manual_seed(1))
    w[w < 0.6] = 0.0
    Gb = bs.G[:251, :Ngrid]
    got = GK.stack_tiles(w, Gb, bs.bands)
    assert torch.equal(got, GK.stack_tiles(w, Gb.contiguous()))
    np.testing.assert_allclose(got.numpy(), (w.double() @ Gb.double())
                               .numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("ignore_model_err", [False, True])
def test_banded_chi2_stack_plain_follows_the_dense_pair(ignore_model_err):
    """The K1 pass B on the models in band order with the tiles' bands
    (G a row-strided view of the sorted G): its PDF and s equal the dense
    pass's on a contiguous G bit for bit, and its PDF the float64 product
    of the same kept weights to float32 roundoff."""
    d, de, mT, meT, G = _problem(5, B=19, M=251, Ngrid=301)
    bs = GK.band_sort(_zero_tile_signed(G, False), mT, meT)
    assert bs.mmT is None
    Gb = bs.G[:251, :301]
    assert not Gb.is_contiguous()
    shift = torch.zeros(19)
    kw = dict(a1=1.5, wthr=1e-3, ignore_model_err=ignore_model_err)
    FM.reset_launch_counts()
    pdf, s = FM.chi2_stack(d, de, bs.mT, bs.meT, Gb, shift, bands=bs.bands,
                           **kw)
    dense, s_d = FM.chi2_stack_plain(d, de, bs.mT, bs.meT, Gb.contiguous(),
                                     shift, **kw)
    assert torch.equal(s, s_d)
    assert torch.equal(pdf, dense)
    w = FM._weights_plain(FM._chi2_plain(d, de, bs.mT, bs.meT,
                                         ignore_model_err), shift[:, None],
                          1.5)
    w = torch.where(w > 1e-3, w, 0.0)
    np.testing.assert_allclose(pdf.numpy(), (w.double() @ Gb.double())
                               .numpy(), rtol=1e-5, atol=1e-9)
    assert FM.launch_counts() == {"chi2_brackets": 0, "chi2_stack": 0}


@pytest.mark.parametrize("bad", ["table", "bands", "G", "rows"])
def test_band_readers_check_their_inputs(bad):
    """`lnl_stack_band` refuses a table of another width and per-row
    inputs of another length; the banded `chi2_stack` refuses bands of
    another shape and a G whose rows are not contiguous."""
    t = _general_problem(M=251, Ngrid=77)
    tb, bs, table, lmap, levid = _band_table_case(t, t[6])
    d, de, mT, meT = t[0], t[1], bs.mT, bs.meT
    Gb, bands, shift = bs.G[:251, :77], bs.bands, torch.zeros(19)
    if bad == "table":
        with pytest.raises(ValueError):
            GK.lnl_stack_band(table[:, :-64], bs, lmap, levid, log_thr=-7.0)
        return
    if bad == "rows":
        with pytest.raises(ValueError):
            GK.lnl_stack_band(table, bs, lmap[:-1].contiguous(), levid,
                              log_thr=-7.0)
        return
    if bad == "bands":
        bands = bands[:-1].contiguous()
    else:
        Gb = bs.G[:251, :77].T.contiguous().T
    with pytest.raises(ValueError):
        FM.chi2_stack(d, de, mT, meT, Gb, shift, a1=1.5, bands=bands)


@pytest.mark.gpu
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("flags,B,M,Ngrid", [
    (dict(), 19, 251, 77),
    (dict(dim_prior=False), 40, 99_937, 301),
    (dict(full_mask=True, ignore_model_err=True), 40, 99_937, 301),
    (dict(), 33, 251, 1030),
])
def test_stack_band_matches_plain_on_card(cuda_device, flags, B, M, Ngrid,
                                          signed):
    """`lnl_stack_band` against its plain version (PDFs row-normwise 1e-5)
    and bit for bit against the recompute `lnl_stack` on the band-ordered
    models and G (the table route's contract), on a table that
    `lnl_reduce` wrote over the band order; M = 99,937 leaves a ragged
    last tile, M = 251 an all-zero one; Ngrid 1030 takes three column
    blocks."""
    t = [x.to(cuda_device) for x in _general_problem(
        5, B=B, M=M, Ngrid=Ngrid, masked=not flags.get("full_mask"))]
    G = _zero_tile_signed(t[6], signed) if M == 251 else t[6].clone()
    if signed and M != 251:
        G[::7] *= -1.0
    tb, bs, table, lmap, levid = _band_table_case(t, G, **flags)
    log_thr = float(np.log(1e-3))
    K.reset_launch_counts()
    got = GK.lnl_stack_band(table, bs, lmap, levid, log_thr=log_thr)
    want = GK.lnl_stack_band_plain(table, bs, lmap, levid, log_thr=log_thr)
    twin = GK.lnl_stack(*tb[:6], tb[6], lmap, levid, log_thr=log_thr,
                        **flags)
    torch.cuda.synchronize()
    assert torch.equal(got, twin)
    scale = want.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=1e-5)
    assert (got != 0).any()
    counts = K.launch_counts()
    assert counts["lnl_stack_band"] == 1 and counts["lnl_stack_table"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("wthr", [1e-3, None])
@pytest.mark.parametrize("B,M,Ngrid", [(19, 251, 77), (40, 99_937, 301),
                                       (33, 700, 1030)])
def test_banded_chi2_stack_matches_plain_on_card(cuda_device, B, M, Ngrid,
                                                 wthr):
    """The K1 pass B in band order against its plain version (s 1e-5,
    PDFs row-normwise 1e-5) and bit for bit against the dense kernel on
    the same band-ordered models and G; the brackets in band order equal
    the caller order's bit for bit."""
    t = [x.to(cuda_device) for x in _problem(5, B=B, M=M, Ngrid=Ngrid)]
    bs = GK.band_sort(t[4], t[2], t[3])
    below, above = FM.chi2_brackets(*t[:4], c0=3.0)
    got_b = FM.chi2_brackets(t[0], t[1], bs.mT, bs.meT, c0=3.0)
    assert torch.equal(got_b[0], below) and torch.equal(got_b[1], above)
    _, shift = TF.lmap_and_shift(below, above, 5)
    Gb = bs.G[:M, :Ngrid]
    FM.reset_launch_counts()
    got = FM.chi2_stack(t[0], t[1], bs.mT, bs.meT, Gb, shift, a1=1.5,
                        wthr=wthr, bands=bs.bands)
    twin = FM.chi2_stack(t[0], t[1], bs.mT, bs.meT, Gb.contiguous(), shift,
                         a1=1.5, wthr=wthr)
    want = FM.chi2_stack_plain(t[0], t[1], bs.mT, bs.meT, Gb, shift, a1=1.5,
                               wthr=wthr, bands=bs.bands)
    torch.cuda.synchronize()
    assert torch.equal(got[0], twin[0]) and torch.equal(got[1], twin[1])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    scale = want[0].abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    torch.testing.assert_close(got[0] / scale, want[0] / scale, rtol=0,
                               atol=1e-5)
    assert FM.launch_counts() == {"chi2_brackets": 0, "chi2_stack": 2}


# The lnl table of the two-pass threshold route: every instantiation
# (fixed or free scale x full or masked x dim prior or Normal x model
# errors kept or ignored).
TABLE_CASES = [dict(free_scale=fs, full_mask=fm, dim_prior=dp,
                    ignore_model_err=ime)
               for fs in (False, True) for fm in (False, True)
               for dp in (True, False) for ime in (False, True)]
TABLE_IDS = ["{}-{}-{}-{}".format(
    "free" if c["free_scale"] else "fixed",
    "full" if c["full_mask"] else "masked",
    "dimprior" if c["dim_prior"] else "normal",
    "ime" if c["ignore_model_err"] else "me") for c in TABLE_CASES]


@pytest.mark.gpu
@pytest.mark.parametrize("F,B,M,Ngrid", [(5, 19, 251, 77),
                                          (5, 40, 99_937, 301)])
@pytest.mark.parametrize("inst", TABLE_CASES, ids=TABLE_IDS)
def test_table_route_equals_recompute_route_on_card(cuda_device, inst, F, B,
                                                    M, Ngrid):
    """The producer (`lnl_reduce`, or `scale_sweeps` under free scale with
    model errors, its sweep table unchanged) and the readers against the
    recompute route bit for bit: lmap, levid, pdf; the table against
    `lnl_tile_plain` within 1 ulp (expected bit-equal, up to the last ulp
    of `log`) and untouched past M.  Masked rows 1-3 hold Ndim 0, 1 and
    2; M = 99,937 leaves a ragged last tile and group."""
    t = [x.to(cuda_device) for x in _general_problem(
        F, B=B, M=M, Ngrid=Ngrid, masked=not inst["full_mask"])]
    flags = dict(inst, sweeps=None, tm=None)
    table = torch.full((B, GK.table_width(M)), torch.nan, device=cuda_device)
    sweep_policy = inst["free_scale"] and not inst["ignore_model_err"]
    K.reset_launch_counts()
    if sweep_policy:
        tm = TF.group_width(M, 512)
        flags.update(tm=tm, sweeps=GK.scale_sweeps(
            *t[:6], tm=tm, full_mask=inst["full_mask"], table=table,
            dim_prior=inst["dim_prior"]))
        assert torch.equal(flags["sweeps"], GK.scale_sweeps(
            *t[:6], tm=tm, full_mask=inst["full_mask"]))
    lmap, levid = GK.lnl_reduce(*t[:6], table=table, **flags)
    pdf = GK.lnl_stack(*t[:6], t[6], lmap, levid, log_thr=np.log(1e-3),
                       table=table, **flags)
    want_lmap, want_levid = GK.lnl_reduce(*t[:6], **flags)
    want_pdf = GK.lnl_stack(*t[:6], t[6], want_lmap, want_levid,
                            log_thr=np.log(1e-3), **flags)
    torch.cuda.synchronize()
    for got, want in ((lmap, want_lmap), (levid, want_levid),
                      (pdf, want_pdf)):
        assert torch.equal(got, want)
    _assert_within_ulp(table[:, :M], GK.lnl_tile_plain(*t[:6], **flags))
    assert torch.isnan(table[:, M:]).all()
    counts = K.launch_counts()
    assert counts["lnl_reduce_table"] == counts["lnl_stack_table"] == 1
    assert counts["lnl_reduce"] == counts["lnl_stack"] == 2
    assert counts["scale_sweeps_table"] == int(sweep_policy)


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [True, False])
def test_table_stack_with_a_signed_G_on_card(cuda_device, masked):
    """`lnl_stack` on the table with a kernel matrix and with a G of
    negative entries and -0.0 rows (whose zero-weight products are not
    all +0): both bit for bit the recompute route, whose sum runs over
    every marked model."""
    t = [x.to(cuda_device) for x in _general_problem(
        5, B=70, M=3000, Ngrid=301, masked=masked)]
    flags = dict(full_mask=not masked, dim_prior=False)
    table = torch.empty((70, GK.table_width(3000)), device=cuda_device)
    lmap, levid = GK.lnl_reduce(*t[:6], table=table, **flags)
    for G in (t[6], t[6].clone()):
        if G is not t[6]:
            G[::7] *= -1.0
            G[3::11] = -0.0
        got = GK.lnl_stack(*t[:6], G, lmap, levid, log_thr=np.log(1e-3),
                           table=table, **flags)
        want = GK.lnl_stack(*t[:6], G, lmap, levid, log_thr=np.log(1e-3),
                            **flags)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert (got != 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("inst", [TABLE_CASES[i] for i in (0, 10, 12)],
                         ids=[TABLE_IDS[i] for i in (0, 10, 12)])
def test_table_route_in_chunks_on_card(cuda_device, inst, monkeypatch):
    """`fused_fit_pdf` with the byte cap at 16 rows of table: 70 rows in
    five chunks of 14 through one buffer, bit for bit one chunk."""
    t = [x.to(cuda_device) for x in _general_problem(
        5, B=70, M=3000, Ngrid=301, masked=not inst["full_mask"])]
    args = (*t[:3], t[3].T, t[4].T, t[5].T, t[6])
    whole = TF.fused_fit_pdf(*args, **inst)
    monkeypatch.setattr(GK, "TABLE_BYTES_MAX", 16 * 4 * GK.table_width(3000))
    K.reset_launch_counts()
    chunked = TF.fused_fit_pdf(*args, **inst)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    # The reader: `lnl_stack` on the caller-order table under free scale
    # with model errors, `lnl_stack_band` otherwise.
    dense = inst["free_scale"] and not inst["ignore_model_err"]
    stack = "lnl_stack_table" if dense else "lnl_stack_band"
    assert counts["lnl_reduce_table"] == counts[stack] == 5
    assert counts["lnl_reduce"] == 5
    assert counts["lnl_stack"] == counts["lnl_stack_table"] == 5 * dense
    for got, want in zip(chunked, whole):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------
# som_train (K8): the whole SOM training run
# ---------------------------------------------------------------------

def _som_problem(nside, F=5, T=400, nproj=2, seed=31, bad_bands=False,
                 nan_band=False, ties=False, zero_scores=False):
    """A lattice, its initial nodes and T cleaned draws, made as the
    kernel route of `SelfOrganizingMap.train_network` makes them.  With
    `nan_band` every ninth model has a NaN in band 1, a masked band whose
    raw NaN reaches the nodes a step moves (their scores are NaN from then
    on); with `ties` every node starts as the same model (exact score ties
    at every lattice distance); with `zero_scores` every third draw has
    every band masked (iv = +0: without the dim prior every node scores
    -0) and every third from the second every band at iv = -0 (every node
    scores +0)."""
    rng = np.random.default_rng(seed)
    M = max(4 * nside ** nproj, 64)
    m = rng.uniform(1, 10, (M, F))
    me = 0.05 * m
    mm = np.ones_like(m)
    if bad_bands:
        me[::7, 0] = 0.0
        mm[1::5, F - 1] = 0.0
    N = nside ** nproj
    idx = np.arange(N)
    pos = np.stack([(idx // nside ** (nproj - 1 - i)) % nside
                    for i in range(nproj)], axis=1).astype(np.float32)
    nodes = m[rng.choice(M, size=N, replace=False)].astype(np.float32)
    if ties:
        nodes[:] = nodes[0]
    if nan_band:
        m[::9, 1] = np.nan
    draws = rng.integers(0, M, T)
    x = m[draws].astype(np.float32)
    xe = me[draws].astype(np.float32)
    ok = np.isfinite(x) & np.isfinite(xe) & (xe > 0) & (mm[draws] == 1)
    iv = np.where(ok, 1.0 / np.where(ok, xe, 1.0) ** 2, 0.0).astype(
        np.float32)
    xc = np.where(ok, x, 0.0).astype(np.float32)
    if zero_scores:
        xc[::3] = 0.0
        iv[::3] = 0.0
        iv[1::3] = -0.0
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (nodes, pos, xc, iv, x)]


_SOM_KW = dict(nside=4, wt_thresh=1e-3, lr=SK.schedule("harmonic", 0.5, 0.1),
               nb=SK.schedule("harmonic", 0.7, 0.02))


def test_som_train_cpu_runs_plain_without_launching():
    t = _som_problem(4)
    SK.reset_launch_counts()
    got, bmu = SK.som_train(*t, return_bmu=True, **_SOM_KW)
    want, bmu_p = SK.som_train_plain(*t, return_bmu=True, **_SOM_KW)
    assert torch.equal(got, want) and torch.equal(bmu, bmu_p)
    assert bmu.dtype == torch.int32 and bmu.shape == (400,)
    assert SK.launch_counts() == {"som_train": 0, "som_train_cluster": 0}
    assert SK.som_train(*t, **_SOM_KW)[1] is None


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "nodes",
                                 "proj"])
def test_som_train_checks_its_inputs(bad):
    t = _som_problem(3, T=8)
    if bad == "dtype":
        t[2] = t[2].double()
    elif bad == "shape":
        t[3] = t[3][:, :4].contiguous()
    elif bad == "contiguity":
        t[0] = t[0].t().contiguous().t()
    elif bad == "nodes":
        t[0] = torch.zeros((SK.MAX_NODES + 1, 5))
        t[1] = torch.zeros((SK.MAX_NODES + 1, 2))
    else:
        t[1] = torch.zeros((9, 9))
    with pytest.raises((TypeError, ValueError)):
        SK.som_train(*t, **_SOM_KW)


def _som_steps_numpy(nodes, pos, xc, iv, xr, nside, wt_thresh, nsteps):
    """The Pallas body's step (networks.py:1335-1395), harmonic rate and
    Gaussian neighbourhood, in float64 NumPy."""
    nodes = nodes.astype(np.float64).copy()
    bmus = []
    for s in range(nsteps):
        xiv = xc[s] * iv[s]
        A = np.sum(xc[s] * xiv)
        inter = nodes @ xiv
        shape = (nodes ** 2) @ iv[s]
        chi2 = A - inter * (inter / np.maximum(shape, 1e-30))
        a1 = 0.5 * (np.sum(iv[s] > 0) - 1.0) - 1.0
        score = a1 * np.log(np.maximum(chi2, 1e-30)) - 0.5 * chi2
        b = int(np.argmax(score))
        bmus.append(b)
        t = s / max(nsteps - 1, 1)
        sigma = 1.0 / ((1 - t) / 0.7 + t / 0.02) * nside
        rate = 1.0 / ((1 - t) / 0.5 + t / 0.1)
        wt = np.exp(-0.5 * ((pos - pos[b]) ** 2).sum(1) / sigma ** 2)
        keep = wt > wt_thresh * wt.max()
        nodes += np.where(keep, rate * wt, 0.0)[:, None] * (xr[s] - nodes)
    return nodes, np.array(bmus)


def test_som_train_plain_follows_the_pallas_step():
    t = _som_problem(4, T=30)
    got, bmu = SK.som_train_plain(*t, return_bmu=True, **_SOM_KW)
    want, want_bmu = _som_steps_numpy(*(x.numpy() for x in t), 4, 1e-3, 30)
    np.testing.assert_array_equal(bmu.numpy(), want_bmu)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_som_train_segments_compose_with_off_and_total():
    """A run cut in two at step 150, each segment told its global offset
    and the run's length, equals the run in one piece bit for bit."""
    t = _som_problem(4, T=400)
    whole, bmu = SK.som_train(*t, return_bmu=True, **_SOM_KW)
    first, b1 = SK.som_train(t[0], t[1], *(x[:150] for x in t[2:]),
                             nsteps_total=400, return_bmu=True, **_SOM_KW)
    second, b2 = SK.som_train(first, t[1], *(x[150:] for x in t[2:]),
                              off=150.0, nsteps_total=400, return_bmu=True,
                              **_SOM_KW)
    assert torch.equal(second, whole)
    assert torch.equal(torch.cat([b1, b2]), bmu)


def test_som_train_breaks_ties_to_the_lowest_index():
    """One valid band: chi^2 of every node cancels to the 1e-30 floor or
    near it, and the plain version (like the Pallas body) takes the
    lowest index among the maximal scores."""
    t = _som_problem(4, T=6)
    t[3][:, 1:] = 0.0  # Ndim 1
    t[2][:, 1:] = 0.0
    nodes, pos, xc, iv, xr = t
    it = nodes * (xc[0] * iv[0])
    sh = (nodes * nodes) * iv[0]
    chi2 = (xc[0, 0] * (xc[0, 0] * iv[0, 0])) - it[:, 0] * (
        it[:, 0] / torch.maximum(sh[:, 0], torch.tensor(1e-30)))
    score = -1.5 * torch.log(torch.maximum(chi2, torch.tensor(1e-30))) \
        - 0.5 * chi2
    top = torch.nonzero(score == score.max()).flatten()
    _, bmu = SK.som_train_plain(*t, return_bmu=True, **_SOM_KW)
    assert int(bmu[0]) == int(top[0])


@pytest.mark.gpu
@pytest.mark.parametrize("nside,F,T,kw", [
    (4, 3, 400, {}),
    (4, 1, 300, {}),
    (7, 20, 600, dict(bad_bands=True)),
    (5, 5, 500, dict(lorentz=True, dim_prior=False,
                     lr=SK.schedule("geometric", 0.6, 0.05),
                     nb=SK.schedule("linear", 0.8, 0.1))),
    (50, 5, 2000, {}),
    (150, 5, 300, {}),
])
@pytest.mark.parametrize("cluster", [1, None])
def test_som_train_matches_plain_on_card(cuda_device, nside, F, T, kw,
                                         cluster):
    """Kernel against plain version on the card: the same best node at
    every step and the same node table, bit for bit, on the block route
    (cluster=1: at nside 150 the table lies past shared memory, in device
    memory; at F = 1 the transposed table the kernel trains must be a
    copy of the input) and on the route the wrapper picks (None)."""
    kw = dict(kw)
    t = [x.to(cuda_device) for x in _som_problem(
        nside, F=F, T=T, bad_bands=kw.pop("bad_bands", False))]
    args = dict(_SOM_KW, nside=nside, **kw)
    N = nside ** 2
    if nside == 150:
        assert SK._build.load().fz_som_train_smem(N, F, 2, 1) > SK._SMEM_MAX
    route = cluster or SK.choose_cluster(
        {k: SK._active(torch.cuda.current_device(), N, F, 2, k)
         for k in SK.CLUSTER_SIZES})
    SK.reset_launch_counts()
    got, bmu = SK.som_train(*t, return_bmu=True, cluster=cluster, **args)
    want, bmu_p = SK.som_train_plain(*t, return_bmu=True, **args)
    torch.cuda.synchronize()
    assert SK.launch_counts() == {"som_train": int(route == 1),
                                  "som_train_cluster": int(route > 1)}
    assert torch.equal(bmu, bmu_p)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert bool(torch.isfinite(got).all())


@pytest.mark.gpu
def test_som_on_card_matches_cpu_and_counts_launches(cuda_device):
    """The SelfOrganizingMap path on the card: training launches
    `som_train` once, on the route its wrapper picks, and lands within 2e-4 of the CPU route (its plain
    version: the CPU's log and exp round differently); populate's member
    tables are equal on the same nodes, and nodes-only and exact-union
    fit_predict agree with the CPU at rtol 2e-3 / atol 2e-5."""
    from frankenz_tpu_torch.models import SelfOrganizingMap

    rng = np.random.default_rng(42)
    centers = rng.uniform(2, 9, (4, 5))
    m = np.vstack([c + rng.normal(0, 0.3, (150, 5)) for c in centers])
    args = (m, np.full_like(m, 0.05), np.ones_like(m))
    kw = dict(nside=6, nproj=2, niter=40, nbatch=25, seed=4, verbose=False)
    cpu = SelfOrganizingMap(*args, device="cpu").train_network(**kw)
    route = SK.choose_cluster({k: SK._active(torch.cuda.current_device(),
                                             36, 5, 2, k)
                               for k in SK.CLUSTER_SIZES})
    K.reset_launch_counts()
    gpu = SelfOrganizingMap(*args, device="cuda").train_network(**kw)
    counts = K.launch_counts()
    assert (counts["som_train"], counts["som_train_cluster"]) == (
        int(route == 1), int(route > 1))
    np.testing.assert_allclose(gpu.nodes, cpu.nodes, rtol=2e-4, atol=2e-4)
    gpu.nodes = cpu.nodes.copy()
    cpu.populate_network(verbose=False)
    gpu.populate_network(verbose=False)
    for name in ("nodes_idxs", "nodes_Nmatch", "nodes_bmus", "nodes_Nbmu"):
        np.testing.assert_array_equal(getattr(gpu, name), getattr(cpu, name))
    d = m[rng.integers(0, len(m), 300)] + rng.normal(0, 0.1, (300, 5))
    z = rng.uniform(0, 3, len(m))
    fit = (d, np.full_like(d, 0.1), np.ones_like(d), z, np.full_like(z, 0.05))
    for nodes_only in (True, False):
        fkw = dict(label_grid=np.linspace(0, 3, 121), nodes_only=nodes_only,
                   save_fits=False, return_gof=True, verbose=False,
                   batch_size=128)
        want = cpu.fit_predict(*fit, **fkw)
        got = gpu.fit_predict(*fit, **fkw)
        np.testing.assert_allclose(got[0], want[0], rtol=2e-3, atol=2e-5)
        for g, w in zip(got[1], want[1]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_som_cluster_choice_follows_the_order_and_the_query():
    """The SOM kernel's route and K from the card's answers alone, by the
    chain kernels' rule: the first of CLUSTER_ORDER that the card holds
    at least once, else the block; a CTA's threads cover its node slots
    within [128, 512]."""
    assert SK.choose_cluster({2: 9, 4: 5, 8: 3, 16: 1}) == 16
    assert SK.choose_cluster({2: 1, 4: 1, 8: 1, 16: 0}) == 8
    assert SK.choose_cluster({k: 0 for k in SK.CLUSTER_SIZES}) == 1
    assert SK.choose_cluster({}) == 1
    for k in SK.CLUSTER_SIZES:
        only = {j: int(j == k) for j in SK.CLUSTER_SIZES}
        assert SK.choose_cluster(only) == k
    assert sorted(SK.CLUSTER_ORDER) == list(SK.CLUSTER_SIZES)
    assert SK.cluster_threads(2500, 16) == 160
    assert SK.cluster_threads(40, 16) == 128
    assert SK.cluster_threads(32768, 2) == 512


@pytest.mark.parametrize("cluster", [1, 2, 16, 0, 3, 32])
def test_som_train_refuses_cluster_on_cpu_and_bad_sizes(cluster):
    """`cluster=` picks a route on the card: a CPU tensor refuses any
    value, and a size outside CLUSTER_SIZES is refused before the device
    is looked at."""
    t = _som_problem(3, T=8)
    with pytest.raises(ValueError):
        SK.som_train(*t, cluster=cluster, **_SOM_KW)


def _som_bits_equal(got, want):
    """Bit for bit, NaN included."""
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


def _require_som_cluster(N, F, P, k):
    if k > 1 and SK._active(torch.cuda.current_device(), N, F, P, k) < 1:
        pytest.skip(f"no cluster of {k} CTAs at N={N}, F={F} on this card")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("nside,F,T,kw", [
    (50, 5, 2000, {}),
    (51, 5, 1500, {}),
    (4, 1, 300, {}),
    (7, 20, 600, dict(bad_bands=True)),
    (5, 5, 500, dict(lorentz=True, dim_prior=False,
                     lr=SK.schedule("geometric", 0.6, 0.05),
                     nb=SK.schedule("linear", 0.8, 0.1))),
    (6, 5, 400, dict(nan_band=True)),
    (9, 5, 400, dict(ties=True)),
    (6, 3, 300, dict(zero_scores=True, dim_prior=False)),
])
def test_som_train_cluster_equals_block_and_plain_on_card(cuda_device, k,
                                                          nside, F, T, kw):
    """Every cluster size against the block route, bit for bit on every
    best node and every node value, and against the plain version (the
    same best nodes, nodes within 1e-6): config 3's 2,500 nodes, N =
    2,601 (no multiple of any K), F = 1, F = 20 (the run-time filter loop)
    with bad bands, the Lorentzian neighbourhood without the dim prior,
    NaN nodes (a NaN score wins, the lowest index among them), exact ties
    (every node the same model), and steps where every score is -0 or
    +0."""
    kw = dict(kw)
    flags = {name: kw.pop(name, False)
             for name in ("bad_bands", "nan_band", "ties", "zero_scores")}
    t = [x.to(cuda_device) for x in _som_problem(nside, F=F, T=T, **flags)]
    _require_som_cluster(nside ** 2, F, 2, k)
    args = dict(_SOM_KW, nside=nside, **kw)
    block, bmu_b = SK.som_train(*t, return_bmu=True, cluster=1, **args)
    SK.reset_launch_counts()
    got, bmu = SK.som_train(*t, return_bmu=True, cluster=k, **args)
    torch.cuda.synchronize()
    route = "som_train" if k == 1 else "som_train_cluster"
    assert SK.launch_counts()[route] == 1
    assert sum(SK.launch_counts().values()) == 1
    assert torch.equal(bmu, bmu_b) and _som_bits_equal(got, block)
    want, bmu_p = SK.som_train_plain(*t, return_bmu=True, **args)
    assert torch.equal(bmu, bmu_p)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0, equal_nan=True)
    if flags["nan_band"]:
        assert bool(torch.isnan(got).any())
    if flags["ties"]:
        assert int(bmu[0]) == 0
    if flags["zero_scores"]:
        assert not bool(bmu[::3].any()) and not bool(bmu[1::3].any())


@pytest.mark.gpu
def test_som_train_segments_compose_across_routes_on_card(cuda_device):
    """A run cut in two at step 700, each segment told its offset and the
    run's length, equals the run in one launch bit for bit whatever route
    each segment takes: block then cluster, cluster then block, and the
    default."""
    t = [x.to(cuda_device) for x in _som_problem(50, T=1500)]
    args = dict(_SOM_KW, nside=50)
    whole, bmu = SK.som_train(*t, return_bmu=True, cluster=1, **args)
    idx = torch.cuda.current_device()
    sizes = [k for k in SK.CLUSTER_SIZES
             if SK._active(idx, 2500, 5, 2, k) >= 1]
    assert sizes, "the card schedules no cluster at config 3's shape"
    for first, second in ((1, sizes[-1]), (sizes[0], 1), (None, None)):
        head, b1 = SK.som_train(t[0], t[1], *(x[:700] for x in t[2:]),
                                nsteps_total=1500, return_bmu=True,
                                cluster=first, **args)
        tail, b2 = SK.som_train(head, t[1], *(x[700:] for x in t[2:]),
                                off=700.0, nsteps_total=1500,
                                return_bmu=True, cluster=second, **args)
        assert _som_bits_equal(tail, whole)
        assert torch.equal(torch.cat([b1, b2]), bmu)


@pytest.mark.gpu
def test_som_train_default_takes_a_cluster_on_card(cuda_device):
    """Config 3's shape (2,500 nodes x 5 filters on a 50 x 50 lattice)
    takes the cluster route by default, at the size `choose_cluster` gives
    for the card's query; a size the card refuses raises."""
    t = [x.to(cuda_device) for x in _som_problem(50, T=200)]
    idx = torch.cuda.current_device()
    active = {k: SK._active(idx, 2500, 5, 2, k) for k in SK.CLUSTER_SIZES}
    assert SK.choose_cluster(active) > 1
    SK.reset_launch_counts()
    SK.som_train(*t, **dict(_SOM_KW, nside=50))
    assert SK.launch_counts() == {"som_train": 0, "som_train_cluster": 1}
    refused = [k for k in SK.CLUSTER_SIZES if active[k] < 1]
    for k in refused:
        with pytest.raises(ValueError):
            SK.som_train(*t, cluster=k, **dict(_SOM_KW, nside=50))


# ---------------------------------------------------------------------
# gng_train (K9): the whole GrowingNeuralGas training run
# ---------------------------------------------------------------------

def _gng_problem(N, F=5, T=400, seed=37, bad_bands=False, hub=False,
                 dup=False):
    """A GNG start state (two seed nodes and their edge; with `hub` a
    node holding 32 edges beside a twin it is not joined to; with `dup` a
    `graph_init` whose edge list repeats an edge and holds a self-loop,
    so rows hold one node in two slots) and T cleaned draws, made as the
    kernel route of `GrowingNeuralGas.train_network` makes them."""
    from frankenz_tpu_torch.models import networks as TN

    rng = np.random.default_rng(seed)
    centers = rng.uniform(2, 9, (4, F))
    m = np.vstack([c + rng.normal(0, 0.3, (max(N // 4, 60), F))
                   for c in centers])
    me = np.full_like(m, 0.05)
    mm = np.ones_like(m)
    if bad_bands:
        me[::7, 0] = 0.0
        mm[1::5, F - 1] = 0.0
    if hub:
        leaves = centers[1:][rng.integers(0, 3, 32)] + rng.normal(
            0, 0.5, (32, F))
        graph = {"pos": np.vstack([centers[0], centers[0] * 1.001, leaves,
                                   centers[3] + 0.1]),
                 "edges": [(0, 2 + k, 0) for k in range(32)] + [(1, 34, 0)]}
        state = TN._gng_seed_state(graph, N, F)
    elif dup:
        graph = {"pos": np.vstack([c + 0.1 * k for c in centers
                                   for k in range(2)]),
                 "edges": [(0, 1, 0), (0, 1, 0), (1, 2, 0), (2, 2, 0),
                           (2, 3, 0), (4, 5, 0), (5, 6, 0), (6, 7, 0),
                           (7, 7, 0), (3, 4, 0)]}
        state = TN._gng_seed_state(graph, N, F)
    else:
        pos = np.zeros((N, F), np.float32)
        pos[:2] = m[rng.choice(len(m), 2, replace=False)]
        alive = np.zeros(N, bool)
        alive[:2] = True
        ids = np.full((N, 32), -1, np.int32)
        ids[0, 0], ids[1, 0] = 1, 0
        state = (pos, np.zeros(N, np.float32), alive, ids,
                 np.zeros((N, 32), np.int32), np.zeros(N, np.int32))
    draws = TN.som_kernel_draws(m, me, mm, rng.integers(0, len(m), T))
    return ([torch.from_numpy(np.ascontiguousarray(a)) for a in state],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in draws])


def _gng_equal(got, want):
    for g, w in zip(got[:6], want[:6]):
        assert torch.equal(g, w)
    assert got[6] == want[6]


def test_gng_train_cpu_runs_plain_without_launching():
    state, draws = _gng_problem(30, T=300)
    K.reset_launch_counts()
    got = GG.gng_train(*state, 0, *draws, nbatch=25)
    want = GG.gng_train_plain(*state, 0, *draws, nbatch=25)
    _gng_equal(got, want)
    assert GG.launch_counts() == {"gng_train": 0, "gng_train_cluster": 0}
    assert int(got[2].sum()) > 2 and got[2].dtype == torch.bool
    assert got[3].dtype == torch.int32 and got[6] == 0


@pytest.mark.parametrize("bad", ["dtype", "ids_dtype", "shape", "contiguity",
                                 "nodes", "filters"])
def test_gng_train_checks_its_inputs(bad):
    state, draws = _gng_problem(30, T=8)
    if bad == "dtype":
        draws[0] = draws[0].double()
    elif bad == "ids_dtype":
        state[3] = state[3].long()
    elif bad == "shape":
        state[4] = state[4][:, :16].contiguous()
    elif bad == "contiguity":
        state[0] = state[0].t().contiguous().t()
    elif bad == "nodes":
        state[0] = torch.zeros((1, 5))
    else:
        state[0] = torch.zeros((30, GG.MAX_FILT + 1))
    with pytest.raises((TypeError, ValueError)):
        GG.gng_train(*state, 0, *draws, nbatch=25)


def test_gng_train_segments_compose():
    """A run cut at a block boundary (step 150 of nbatch 25), the second
    segment started from the first one's whole state, equals the run in
    one piece bit for bit."""
    state, draws = _gng_problem(30, T=400)
    whole = GG.gng_train(*state, 0, *draws, nbatch=25)
    first = GG.gng_train(*state, 0, *(d[:150] for d in draws), nbatch=25)
    second = GG.gng_train(*first, *(d[150:] for d in draws), nbatch=25)
    _gng_equal(second, whole)


def test_gng_train_hub_overflows_and_moves_column_neighbours():
    """The hub holds 32 edges, so an edge to its twin lands in the twin's
    slots only: `overflow` counts the drops, and the twin, whose slots
    hold the hub, moves as the hub's neighbour (the column search)."""
    state, draws = _gng_problem(40, F=3, T=100, hub=True)
    out = GG.gng_train(*state, 0, *draws, nbatch=25, max_age=1000)
    assert out[6] > 0
    ids = out[3]
    one_sided = [(i, int(j)) for i in range(40) for j in ids[i]
                 if 0 <= j < 40 and not bool((ids[int(j)] == i).any())]
    assert one_sided


@pytest.mark.gpu
@pytest.mark.parametrize("N,F,T,kw", [
    (2500, 5, 3000, dict(nbatch=1)),
    (2500, 5, 4000, dict(nbatch=50)),
    (60, 5, 1500, dict(nbatch=10, bad_bands=True, dim_prior=False)),
    (40, 3, 300, dict(nbatch=25, hub=True, max_age=1000)),
    (40, 5, 300, dict(nbatch=25, dup=True, max_age=1000)),
    (300, 1, 1200, dict(nbatch=5)),
    (300, 9, 1200, dict(nbatch=5)),
    (12000, 5, 1500, dict(nbatch=1)),
])
def test_gng_train_matches_plain_on_card(cuda_device, N, F, T, kw):
    """Kernel against plain version on the card, bit for bit on every
    state array: a graph grown to 2,500 nodes (nbatch 1 inserts every
    step), the default block length, bad bands without the dim prior,
    the overflow hub (the column search), rows holding a node twice (it
    moves once), F = 1 and F = 9 (the run-time filter loop), and 12,000
    nodes (the state past shared memory)."""
    kw = dict(kw)
    state, draws = _gng_problem(N, F=F, T=T, bad_bands=kw.pop(
        "bad_bands", False), hub=kw.pop("hub", False),
        dup=kw.pop("dup", False))
    state = [x.to(cuda_device) for x in state]
    draws = [x.to(cuda_device) for x in draws]
    GG.reset_launch_counts()
    got = GG.gng_train(*state, 0, *draws, **kw)
    want = GG.gng_train_plain(*state, 0, *draws, **kw)
    torch.cuda.synchronize()
    assert sum(GG.launch_counts().values()) == 1
    _gng_equal(got, want)
    assert bool(torch.isfinite(got[0]).all())
    assert int(got[2].sum()) > 2


def test_gng_cluster_choice_follows_the_order_and_the_query():
    """The route and K from the card's answers alone: the first of
    CLUSTER_ORDER that the card holds at least once, else the block; a
    CTA's threads cover its node slots within [128, 512]."""
    assert GG.choose_cluster({2: 9, 4: 5, 8: 3, 16: 1}) == GG.CLUSTER_ORDER[0]
    assert GG.choose_cluster({k: 0 for k in GG.CLUSTER_SIZES}) == 1
    assert GG.choose_cluster({}) == 1
    for k in GG.CLUSTER_SIZES:
        only = {j: int(j == k) for j in GG.CLUSTER_SIZES}
        assert GG.choose_cluster(only) == k
    assert sorted(GG.CLUSTER_ORDER) == list(GG.CLUSTER_SIZES)
    assert GG.cluster_threads(2500, 8) == 320
    assert GG.cluster_threads(40, 16) == 128
    assert GG.cluster_threads(32768, 2) == 512


@pytest.mark.parametrize("cluster", [1, 2, 16, 0, 3, 32])
def test_gng_train_refuses_cluster_on_cpu_and_bad_sizes(cluster):
    """`cluster=` picks a route on the card: a CPU tensor refuses any
    value, and a size outside CLUSTER_SIZES is refused before the device
    is looked at."""
    state, draws = _gng_problem(30, T=8)
    with pytest.raises(ValueError):
        GG.gng_train(*state, 0, *draws, nbatch=25, cluster=cluster)


def _gng_on(device, N, F=5, T=400, **kw):
    state, draws = _gng_problem(N, F=F, T=T, **kw)
    return ([x.to(device) for x in state], [x.to(device) for x in draws])


def _require_cluster(N, F, k):
    if k > 1 and GG._active(torch.cuda.current_device(), N, F, k) < 1:
        pytest.skip(f"no cluster of {k} CTAs at N={N}, F={F} on this card")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("N,F,T,kw", [
    (2500, 5, 3000, dict(nbatch=50)),
    (2500, 5, 1500, dict(nbatch=1)),
    (2501, 5, 1200, dict(nbatch=3)),
    (40, 3, 300, dict(nbatch=25, hub=True, max_age=1000)),
    (40, 5, 300, dict(nbatch=25, dup=True, max_age=1000)),
    (300, 9, 800, dict(nbatch=5, bad_bands=True, dim_prior=False)),
])
def test_gng_train_cluster_equals_block_and_plain_on_card(cuda_device, k, N,
                                                          F, T, kw):
    """Every cluster size against the block route and the plain version,
    bit for bit on every state array: the default block length, a graph
    grown by an insert every step, N = 2,501 (no multiple of any K), the
    overflow hub, rows holding a node twice, F = 9 with bad bands."""
    kw = dict(kw)
    _require_cluster(N, F, k)
    state, draws = _gng_on(cuda_device, N, F=F, T=T, bad_bands=kw.pop(
        "bad_bands", False), hub=kw.pop("hub", False),
        dup=kw.pop("dup", False))
    block = GG.gng_train(*state, 0, *draws, cluster=1, **kw)
    GG.reset_launch_counts()
    got = GG.gng_train(*state, 0, *draws, cluster=k, **kw)
    torch.cuda.synchronize()
    route = "gng_train" if k == 1 else "gng_train_cluster"
    assert GG.launch_counts()[route] == 1
    assert sum(GG.launch_counts().values()) == 1
    _gng_equal(got, block)
    _gng_equal(got, GG.gng_train_plain(*state, 0, *draws, **kw))
    if kw.get("max_age") == 1000 and N == 40 and F == 3:
        assert got[6] > 0


@pytest.mark.gpu
def test_gng_train_segments_compose_across_routes_on_card(cuda_device):
    """A run cut at a block boundary composes whatever route each segment
    takes: block then cluster, cluster then block, and the default."""
    state, draws = _gng_on(cuda_device, 2500, T=2000)
    kw = dict(nbatch=50)
    whole = GG.gng_train(*state, 0, *draws, cluster=1, **kw)
    sizes = [k for k in GG.CLUSTER_SIZES
             if GG._active(torch.cuda.current_device(), 2500, 5, k) >= 1]
    assert sizes, "the card schedules no cluster at config 3's shape"
    for first, second in ((1, sizes[-1]), (sizes[0], 1), (None, None)):
        head = GG.gng_train(*state, 0, *(d[:1000] for d in draws),
                            cluster=first, **kw)
        tail = GG.gng_train(*head, *(d[1000:] for d in draws),
                            cluster=second, **kw)
        _gng_equal(tail, whole)


@pytest.mark.gpu
def test_gng_train_too_large_for_a_cluster_takes_the_block(cuda_device):
    """32,768 nodes: no CTA of any cluster size holds its share, so the
    default takes the block route (and a forced cluster is refused)."""
    state, draws = _gng_on(cuda_device, GG.MAX_NODES, T=60)
    idx = torch.cuda.current_device()
    assert all(GG._active(idx, GG.MAX_NODES, 5, k) == 0
               for k in GG.CLUSTER_SIZES)
    GG.reset_launch_counts()
    got = GG.gng_train(*state, 0, *draws, nbatch=5)
    torch.cuda.synchronize()
    assert GG.launch_counts() == {"gng_train": 1, "gng_train_cluster": 0}
    _gng_equal(got, GG.gng_train_plain(*state, 0, *draws, nbatch=5))
    with pytest.raises(ValueError):
        GG.gng_train(*state, 0, *draws, nbatch=5, cluster=16)


@pytest.mark.gpu
def test_gng_train_default_takes_a_cluster_on_card(cuda_device):
    """Config 3's shape (2,500 nodes x 5 filters) takes the cluster route
    by default, at the size `choose_cluster` gives for the card's query."""
    state, draws = _gng_on(cuda_device, 2500, T=200)
    idx = torch.cuda.current_device()
    want = GG.choose_cluster({k: GG._active(idx, 2500, 5, k)
                              for k in GG.CLUSTER_SIZES})
    assert want > 1
    GG.reset_launch_counts()
    GG.gng_train(*state, 0, *draws, nbatch=50)
    assert GG.launch_counts() == {"gng_train": 0, "gng_train_cluster": 1}


# ---------------------------------------------------------------------
# The population chain (K10).
# ---------------------------------------------------------------------


def _pop_problem(nbins=12, nobs=300, T=40, mh=2, nchains=1, seed=41,
                 zero_overlap=False, spread=1.0):
    """(draws, pdfsT, pos, ov, lnp) float32 on the CPU: Gaussian PDFs with
    a floor, a random start on the simplex and a random draw table whose
    normals are scaled by `spread`.  With `zero_overlap` the position holds
    no mass in the last 4 bins (pairs that touch them have scale 0, whose
    gradient is NaN: every proposal is rejected) and the first 5 objects
    have PDFs in those bins only, so their overlaps are 0 and sit on the
    1e-30 floor; `spread` 4 then sends many proposals to a negative bin."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, nbins - 1, (nobs, 1))
    pdfs = np.exp(-0.5 * ((np.arange(nbins)[None] - c) / 1.5) ** 2) + 0.01
    pos = rng.dirichlet(np.full(nbins, 5.0), nchains)
    if zero_overlap:
        pdfs[:5, :nbins - 4] = 0.0
        pdfs[5:, nbins - 4:] = 0.0
        pos[:, nbins - 4:] = 0.0
    pdfs /= pdfs.sum(axis=1, keepdims=True)
    pos /= pos.sum(axis=1, keepdims=True)
    i = rng.integers(0, nbins, (nchains, T))
    j = rng.integers(0, nbins - 1, (nchains, T))
    j = j + (j >= i)
    draws = np.concatenate(
        [i[..., None], j[..., None],
         spread * rng.normal(size=(nchains, T, mh)),
         rng.exponential(size=(nchains, T, mh))], axis=2).astype(np.float32)
    pdfsT = torch.from_numpy(np.ascontiguousarray(pdfs.T.astype(np.float32)))
    pos = torch.from_numpy(pos.astype(np.float32))
    ov = (pos @ pdfsT).contiguous()
    lnp = PK.tree_sum(torch.log(ov.clamp_min(1e-30)), PK.chain_threads(nobs))
    return [torch.from_numpy(draws), pdfsT, pos, ov, lnp]


def _pop_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_pop_chain_cpu_runs_plain_without_launching():
    t = _pop_problem(T=40, mh=2)
    K.reset_launch_counts()
    got = PK.pop_chain(*t, thin=10, mh_steps=2)
    want = PK.pop_chain_plain(*t, thin=10, mh_steps=2)
    _pop_equal(got, want)
    assert PK.launch_counts() == {"pop_chain": 0, "pop_chain_cluster": 0}
    assert K.launch_counts()["pop_chain"] == 0
    samples, lnps, pos, ov, lnp = got
    assert samples.shape == (1, 4, 12) and lnps.shape == (1, 4)
    assert torch.equal(samples[:, -1], pos) and torch.equal(lnps[:, -1], lnp)
    # The chain moved, stayed on the simplex, and its carried overlap and
    # lnpost are those of its position.
    assert not torch.equal(pos, t[2])
    assert bool((pos >= 0).all()) and abs(float(pos.sum()) - 1.0) < 1e-5
    torch.testing.assert_close(ov, pos @ t[1], rtol=1e-4, atol=1e-7)
    want_lnp = torch.log((pos.double() @ t[1].double())).sum(dim=1)
    torch.testing.assert_close(lnp.double(), want_lnp, rtol=1e-5, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "width",
                                 "thin", "bins", "mh"])
def test_pop_chain_checks_its_inputs(bad):
    t = _pop_problem(T=8, mh=2)
    kw = dict(thin=4, mh_steps=2)
    if bad == "dtype":
        t[0] = t[0].double()
    elif bad == "shape":
        t[3] = t[3][:, :-1].contiguous()
    elif bad == "contiguity":
        t[1] = t[1].t().contiguous().t()
    elif bad == "width":
        kw["mh_steps"] = 3
    elif bad == "thin":
        kw["thin"] = 3
    elif bad == "bins":
        t[1] = torch.rand((PK.MAX_BINS + 1, 300))
        t[2] = torch.rand((1, PK.MAX_BINS + 1))
    else:
        t[0] = torch.zeros((1, 8, 2 + 2 * 64))
        kw["mh_steps"] = 64
    with pytest.raises((TypeError, ValueError)):
        PK.pop_chain(*t, **kw)


def test_pop_chain_segments_compose_and_chains_are_independent():
    """A run cut at a thin boundary, the second segment started from the
    first one's carry, equals the run in one piece bit for bit; chain c of
    a batch equals a run on chain c's table alone."""
    t = _pop_problem(T=60, mh=3, nchains=3)
    kw = dict(thin=5, mh_steps=3)
    whole = PK.pop_chain(*t, **kw)
    first = PK.pop_chain(t[0][:, :25].contiguous(), t[1], *t[2:], **kw)
    second = PK.pop_chain(t[0][:, 25:].contiguous(), t[1], *first[2:], **kw)
    assert torch.equal(torch.cat([first[0], second[0]], dim=1), whole[0])
    assert torch.equal(torch.cat([first[1], second[1]], dim=1), whole[1])
    _pop_equal(second[2:], whole[2:])
    for c in range(3):
        one = PK.pop_chain(t[0][c:c + 1].contiguous(), t[1],
                           *(x[c:c + 1].contiguous() for x in t[2:]), **kw)
        _pop_equal(one, [x[c:c + 1] for x in whole])


@pytest.mark.parametrize("nobs,threads", [(1, 128), (300, 128), (1237, 256),
                                          (5000, 1024), (20000, 1024)])
def test_tree_sum_is_a_sum_and_follows_the_thread_count(nobs, threads):
    assert PK.chain_threads(nobs) == threads
    rng = np.random.default_rng(nobs)
    v = torch.from_numpy(rng.normal(-5, 3, (2, nobs)).astype(np.float32))
    got = PK.tree_sum(v, threads)
    want = v.double().sum(dim=1)
    # A pairwise tree: the error grows with log2(nobs), not nobs.
    assert bool(((got.double() - want).abs()
                 <= 16 * 6e-8 * v.double().abs().sum(dim=1)).all())
    # Padding zeros and the order of whole rows change nothing.
    rows = PK._rows_per_thread(nobs, threads)
    padded = torch.zeros((2, rows * threads))
    padded[:, :nobs] = v
    by_hand = padded.reshape(2, rows, threads)
    while by_hand.shape[1] > 1:
        h = by_hand.shape[1] // 2
        by_hand = by_hand[:, :h] + by_hand[:, h:]
    lanes = by_hand.reshape(2, threads // 32, 32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes[..., :o] + lanes[..., o:2 * o]
    warps = torch.zeros((2, 32))
    warps[:, :threads // 32] = lanes[..., 0]
    for o in (16, 8, 4, 2, 1):
        warps = warps[..., :o] + warps[..., o:2 * o]
    assert torch.equal(got, warps[:, 0])


def test_pop_chain_floors_zero_overlaps_and_scores_negative_bins():
    """Objects with no overlap sit on the 1e-30 floor (log 1e-30 each in
    lnpost), a proposal into a negative bin scores -3.0e38 and is
    rejected, and a pair with an empty bin (scale 0, NaN gradient) moves
    nothing: the chain stays finite and on the simplex."""
    t = _pop_problem(T=120, mh=3, zero_overlap=True, spread=4.0)
    samples, lnps, pos, ov, lnp = PK.pop_chain(*t, thin=10, mh_steps=3)
    assert bool(torch.isfinite(samples).all()) and bool((samples >= 0).all())
    assert bool(torch.isfinite(lnps).all())
    assert bool((pos[:, -4:] == 0).all()) and bool((ov[:, :5] == 0).all())
    floor = 5 * float(np.log(np.float32(1e-30)))
    rest = torch.log((pos.double() @ t[1].double())[:, 5:]).sum(dim=1)
    torch.testing.assert_close(lnp.double(), rest + floor, rtol=1e-5, atol=0)
    assert not torch.equal(pos, t[2])
    # With exponentials of 1e30 every finite score is accepted, so only
    # the -3.0e38 score keeps a move to a negative bin out: the table's
    # 4-sigma normals propose many.
    t[0][..., 5:] = 1e30
    wild = PK.pop_chain(*t, thin=10, mh_steps=3)
    assert bool((wild[0] >= 0).all()) and bool(torch.isfinite(wild[1]).all())
    assert not torch.equal(wild[2], pos)
    assert PK.NEG == -3.0e38


POP_CARD_CASES = [
    (dict(nbins=50, nobs=20000, T=300, mh=3), dict(thin=50)),
    (dict(nbins=20, nobs=1237, T=400, mh=3), dict(thin=8)),
    (dict(nbins=12, nobs=300, T=400, mh=1), dict(thin=1)),
    (dict(nbins=12, nobs=300, T=300, mh=5), dict(thin=3)),
    (dict(nbins=50, nobs=20000, T=200, mh=3, nchains=3), dict(thin=20)),
    (dict(nbins=50, nobs=20000, T=200, mh=3), dict(thin=50, resident=False)),
    (dict(nbins=128, nobs=40000, T=100, mh=2, nchains=2), dict(thin=10)),
    (dict(nbins=12, nobs=300, T=400, mh=3, zero_overlap=True, spread=4.0),
     dict(thin=10)),
    (dict(nbins=2, nobs=5, T=50, mh=63), dict(thin=5)),
    (dict(nbins=8, nobs=300_000, T=30, mh=2), dict(thin=10)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("prob,kw", POP_CARD_CASES)
def test_pop_chain_matches_plain_on_card(cuda_device, prob, kw):
    """Kernel against plain version on the card, bit for bit on samples,
    lnpost and the carry: config 5's shape (50 bins x 20,000 objects), an
    object count that is no multiple of the block, mh_steps 1 and 5 (the
    run-time proposal loop), three chains in one launch, the non-resident
    variant forced and past shared memory (40,000 objects, 128 bins), the
    zero-overlap case, the widest draw row, and 300,000 objects (293 a
    thread)."""
    kw = dict(kw)
    resident = kw.pop("resident", None)
    t = [x.to(cuda_device) for x in _pop_problem(**prob)]
    PK.reset_launch_counts()
    got = PK.pop_chain(*t, mh_steps=prob["mh"], resident=resident, **kw)
    want = PK.pop_chain_plain(*t, mh_steps=prob["mh"], **kw)
    torch.cuda.synchronize()
    assert sum(PK.launch_counts().values()) == 1
    if resident is False:
        assert PK.launch_counts()["pop_chain"] == 1
    _pop_equal(got, want)
    assert bool(torch.isfinite(got[0]).all())
    assert not torch.equal(got[2], t[2])
    if resident is False:
        _pop_equal(PK.pop_chain(*t, mh_steps=prob["mh"], **kw), got)


def _split_sum(v, threads, k):
    """The chain's sum as a cluster of k CTAs would fold it, CTA c holding
    the warps w = c + k m: each thread's rows and each warp's lanes as
    `tree_sum` folds them, then CTA c halves over its 32 / k warp slots
    (warp m at slot m, zero-padded), then the k CTA partials halve over c."""
    nobs = v.shape[-1]
    rows = PK._rows_per_thread(nobs, threads)
    padded = torch.zeros(v.shape[:-1] + (rows * threads,), dtype=v.dtype)
    padded[..., :nobs] = v
    x = PK._halve(padded.reshape(v.shape[:-1] + (rows, threads)), -2)
    x = PK._halve(x.reshape(v.shape[:-1] + (threads // 32, 32)), -1)[..., 0]
    slots = torch.zeros(v.shape[:-1] + (32,), dtype=v.dtype)
    slots[..., :threads // 32] = x
    per_cta = slots.reshape(v.shape[:-1] + (32 // k, k))  # [m, c]
    part = PK._halve(per_cta, -2)[..., 0, :]
    return PK._halve(part, -1)[..., 0]


@pytest.mark.parametrize("nobs", [1, 5, 300, 1237, 4097, 5000, 20000,
                                  65537, 100000])
def test_warp_class_split_equals_tree_sum(nobs):
    """The halving over the 32 warp slots pairs w with w + 16, ..., so its
    last log2(K) levels combine the K residue classes of w mod K: a
    cluster whose CTA c holds the warps w = c (mod K) folds the same tree
    for every K = 1 to 32, bit for bit."""
    threads = PK.chain_threads(nobs)
    rng = np.random.default_rng(nobs)
    v = torch.from_numpy(rng.normal(-5, 3, (3, nobs)).astype(np.float32))
    want = PK.tree_sum(v, threads)
    for k in (1, 2, 4, 8, 16, 32):
        assert torch.equal(_split_sum(v, threads, k), want), k


def _leaf_rows(G):
    """The rows of a tree thread's 8 G leaves in the order its fold merges
    them (the kernel's `leaf_row`): leaf 8 g + i is row kb(g) + q G, q the
    3-bit reversal of i, kb(g) the bit reversal of g over log2 G bits."""
    bits = G.bit_length() - 1

    def rev(x, n):
        return int(format(x, f"0{n}b")[::-1], 2) if n else 0

    return [rev(lam >> 3, bits) + rev(lam & 7, 3) * G for lam in range(8 * G)]


@pytest.mark.parametrize("nobs", [5, 1237, 20000, 40000, 100000])
def test_leaf_split_equals_a_thread_fold(nobs):
    """A tree thread's objects taken in leaf order and folded as a complete
    binary tree (adjacent pairs first) give the thread's halving fold over
    its rows bit for bit: any aligned block of leaves, such as the cluster
    route's blocks of whole groups of 8, is a subtree, so S threads may
    fold one block each and shuffles merge the blocks."""
    threads = PK.chain_threads(nobs)
    rows = PK._rows_per_thread(nobs, threads)
    G = rows // 8
    rng = np.random.default_rng(nobs + 1)
    v = torch.from_numpy(rng.normal(-5, 3, nobs).astype(np.float32))
    padded = torch.zeros(rows * threads)
    padded[:nobs] = v
    grid = padded.reshape(rows, threads)
    want = PK._halve(grid, 0)[0]
    leaves = grid[_leaf_rows(G)]
    while leaves.shape[0] > 1:
        leaves = leaves[0::2] + leaves[1::2]
    assert torch.equal(leaves[0], want)


def test_pop_cluster_sizes_and_choice():
    """The sizes a shape admits (K divides the warp count, a CTA holds a
    draw row) and the choice from the card's answers alone: the largest K
    with every chain held at once and nchains x K CTAs within the SMs,
    else the block."""
    assert PK.cluster_sizes(20000, 8) == (2, 4, 8, 16)
    assert PK.cluster_sizes(300, 8) == (2, 4)          # 128 threads
    assert PK.cluster_sizes(300, 128) == ()            # a row of 128
    assert PK.cluster_sizes(20000, 128) == (2, 4, 8)
    active = {2: 66, 4: 33, 8: 16, 16: 7}
    assert PK.choose_cluster(1, 132, active) == 16
    assert PK.choose_cluster(4, 132, active) == 16
    assert PK.choose_cluster(8, 132, active) == 8      # 7 clusters of 16
    assert PK.choose_cluster(20, 132, active) == 4
    assert PK.choose_cluster(132, 132, active) == 1
    assert PK.choose_cluster(1, 132, {2: 0, 4: 0}) == 1
    assert PK.choose_cluster(1, 132, {}) == 1
    assert PK.choose_cluster(1, 132, {2: 1, 8: 1, 16: 0}) == 8


@pytest.mark.parametrize("cluster,resident", [(1, None), (2, None),
                                              (16, None), (3, None),
                                              (32, None), (2, False)])
def test_pop_chain_refuses_cluster_on_cpu_and_bad_sizes(cluster, resident):
    """`cluster=` picks a route on the card: a CPU tensor refuses any
    value; a size the shape does not admit, or a cluster without
    residency, is refused before the device is looked at."""
    t = _pop_problem(T=8, mh=2)
    with pytest.raises(ValueError):
        PK.pop_chain(*t, thin=4, mh_steps=2, cluster=cluster,
                     resident=resident)


def _require_pop_cluster(nobs, mh, k):
    width = 2 + 2 * mh
    if k > 1 and (k not in PK.cluster_sizes(nobs, width) or PK._active(
            torch.cuda.current_device(), nobs, width, mh, k) < 1):
        pytest.skip(f"no cluster of {k} CTAs at {nobs} objects here")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("prob,kw", [
    (dict(nbins=50, nobs=20000, T=300, mh=3), dict(thin=50)),
    (dict(nbins=50, nobs=20000, T=60, mh=3, nchains=3), dict(thin=20)),
    (dict(nbins=20, nobs=1237, T=304, mh=3), dict(thin=8)),
    (dict(nbins=12, nobs=300, T=300, mh=5), dict(thin=3)),
    (dict(nbins=12, nobs=300, T=400, mh=3, zero_overlap=True, spread=4.0),
     dict(thin=10)),
    (dict(nbins=128, nobs=40000, T=60, mh=2, nchains=2), dict(thin=10)),
    (dict(nbins=8, nobs=300_000, T=20, mh=2), dict(thin=10)),
])
def test_pop_chain_cluster_equals_block_and_plain_on_card(cuda_device, k,
                                                          prob, kw):
    """Every cluster size against the block route and the plain version,
    bit for bit on samples, lnpost and the carry: config 5's shape, three
    chains, a ragged object count, the run-time proposal loop, the
    zero-overlap case, 40,000 objects x 128 bins and 300,000 objects."""
    _require_pop_cluster(prob["nobs"], prob["mh"], k)
    t = [x.to(cuda_device) for x in _pop_problem(**prob)]
    block = PK.pop_chain(*t, mh_steps=prob["mh"], cluster=1, **kw)
    PK.reset_launch_counts()
    got = PK.pop_chain(*t, mh_steps=prob["mh"], cluster=k, **kw)
    torch.cuda.synchronize()
    assert PK.launch_counts()["pop_chain" if k == 1 else
                              "pop_chain_cluster"] == 1
    assert sum(PK.launch_counts().values()) == 1
    _pop_equal(got, block)
    if prob["nobs"] <= 20000 or prob["T"] <= 20:
        _pop_equal(got, PK.pop_chain_plain(*t, mh_steps=prob["mh"], **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("nchains", [1, 3, 132])
def test_pop_chain_default_route_by_chain_count_on_card(cuda_device,
                                                        nchains):
    """The default route for 1, 3 and 132 chains at config 5's shape is
    `choose_cluster`'s for the card's query (one chain on a cluster, 132
    on blocks), equal to the block route bit for bit; resident=False
    keeps the block."""
    t = [x.to(cuda_device) for x in _pop_problem(
        nbins=50, nobs=20000, T=40, mh=3, nchains=nchains)]
    kw = dict(thin=10, mh_steps=3)
    idx = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    want = PK.choose_cluster(nchains, sms, {
        k: PK._active(idx, 20000, 8, 3, k)
        for k in PK.cluster_sizes(20000, 8)})
    if nchains == 1:
        assert want > 1
    if nchains >= sms:
        assert want == 1
    block = PK.pop_chain(*t, cluster=1, **kw)
    PK.reset_launch_counts()
    got = PK.pop_chain(*t, **kw)
    assert PK.launch_counts()[
        "pop_chain" if want == 1 else "pop_chain_cluster"] == 1
    _pop_equal(got, block)
    PK.reset_launch_counts()
    nonres = PK.pop_chain(*t, resident=False, **kw)
    assert PK.launch_counts() == {"pop_chain": 1, "pop_chain_cluster": 0}
    _pop_equal(nonres, block)


@pytest.mark.gpu
def test_samplers_on_card_match_cpu_and_count_launches(cuda_device):
    """Through the entry points: a seeded population run takes the same
    table and start on the card (the kernel, every chain in one launch)
    as on the CPU (its plain version) and agrees at the parity tolerance
    over a short chain; `sample` in blocks streams the stored chain bit
    for bit; a prior takes the step loop without a launch; the
    hierarchical sampler runs on the card."""
    from frankenz_tpu_torch.samplers import (hierarchical_sampler,
                                             population_sampler)

    rng = np.random.default_rng(3)
    c = rng.uniform(2, 17, (400, 1))
    pdfs = np.exp(-0.5 * ((np.arange(20)[None] - c) / 0.8) ** 2) + 1e-4
    pdfs /= pdfs.sum(axis=1, keepdims=True)
    kw = dict(thin=10, mh_steps=3, seed=7, nchains=3, verbose=False)
    cpu = population_sampler(pdfs, device="cpu")
    cpu.run_mcmc(4, **kw)
    card = population_sampler(pdfs, device=cuda_device)
    K.reset_launch_counts()
    card.run_mcmc(4, **kw)
    assert sum(K.launch_counts().values()) == 1
    assert K.launch_counts()["pop_chain"] + K.launch_counts()[
        "pop_chain_cluster"] == 1
    np.testing.assert_allclose(card.results[0], cpu.results[0], rtol=2e-4,
                               atol=2e-6)
    np.testing.assert_allclose(card.results[1], cpu.results[1], rtol=2e-5,
                               atol=2e-4)
    del kw["verbose"]
    fresh = population_sampler(pdfs, device=cuda_device)
    want, want_lnp = card.results_by_chain
    for i, (pos, lnp) in enumerate(fresh.sample(4, block=3, **kw)):
        np.testing.assert_array_equal(pos, want[i])
        np.testing.assert_array_equal(lnp, want_lnp[i])
    K.reset_launch_counts()
    prior = population_sampler(pdfs, device=cuda_device)
    prior.run_mcmc(2, logprior_nz=lambda pos: torch.log(pos).sum(), thin=5,
                   seed=1, verbose=False)
    assert sum(K.launch_counts().values()) == 0
    assert np.isfinite(prior.results[1]).all()
    hier = hierarchical_sampler(pdfs, device=cuda_device)
    hier.run_mcmc(6, thin=3, seed=2, nchains=2, verbose=False)
    s, lnp = hier.results_by_chain
    assert s.shape == (6, 2, 20) and np.isfinite(lnp).all()
    np.testing.assert_allclose(s.sum(axis=2), 1.0, atol=1e-3)


# ---------------------------------------------------------------------
# The screened full-mask trio (K2).
# ---------------------------------------------------------------------

SCREENED = ["screen_seed", "chi2_brackets_screened", "chi2_stack_screened"]


def _screened_problem(F=5, B=70, M=700, Ngrid=77, sm=128, tm=256,
                      ignore_model_err=False, seed=43, device="cpu"):
    """A batch sorted and bounded by the glue (`ops.screen`), ragged in
    B, M and Ngrid against the blocks and subtiles; row 0 an all-clamped
    outlier."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(1, 10, (M, F)).astype(np.float32)
    d = (m[rng.integers(0, M, B)]
         + rng.normal(0, 0.3, (B, F))).astype(np.float32)
    d[0] = 1e6
    G = TK.kernel_matrix(rng.uniform(0, 3, M), np.full(M, 0.1),
                         np.linspace(0, 3, Ngrid), device="cpu",
                         dx=None if Ngrid > 1 else 0.1).to(torch.float32)
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (
        d, np.full((B, F), 0.3, np.float32), m.T, (0.05 * m).T)]
    return SC.sort_and_bound(*t, G.contiguous().to(device), sm=sm, tm=tm,
                             tb=SCK.TB, ignore_model_err=ignore_model_err)


def _screened_calls(srt, plain=False, ignore_model_err=False,
                    wt_thresh=1e-3, absorb=True):
    """{name: outputs} of the three wrappers (or their plain versions)
    on one sorted batch, each pass fed the plain versions' outputs."""
    F = srt.d.shape[1]
    a1 = 0.5 * F - 1.0
    args = (srt.d, srt.de, srt.mT, srt.meT)
    kw = dict(ignore_model_err=ignore_model_err)
    pick = (lambda fn: getattr(SCK, fn.__name__ + "_plain")) if plain else (
        lambda fn: fn)
    out = {"screen_seed": (pick(SCK.screen_seed)(
        *args, srt.start, width=srt.tm, c0=2 * a1, **kw),)}
    seed = torch.minimum(srt.seed, SCK.screen_seed_plain(
        *args, srt.start, width=srt.tm, c0=2 * a1, **kw))
    out["chi2_brackets_screened"] = pick(SCK.chi2_brackets_screened)(
        *args, srt.bounds, seed, c0=2 * a1, sm=srt.sm, **kw)
    below, above = SCK.chi2_brackets_screened_plain(
        *args, srt.bounds, seed, c0=2 * a1, sm=srt.sm, **kw)
    g = SC.stack_gates(srt, below, above, wt_thresh=wt_thresh, absorb=absorb)
    out["chi2_stack_screened"] = pick(SCK.chi2_stack_screened)(
        *args, srt.G, g.shift, srt.bounds, g.visit, g.cut_uf, g.cut_dot,
        g.ph, g.cut_abs, a1=a1, sm=srt.sm,
        wthr=None if wt_thresh is None else float(np.float32(wt_thresh)),
        **kw)
    return out


def test_cpu_screened_wrappers_run_plain_versions_without_launching():
    srt = _screened_problem()
    K.reset_launch_counts()
    got = _screened_calls(srt)
    want = _screened_calls(srt, plain=True)
    for name in SCREENED:
        for g, w in zip(got[name], want[name]):
            assert torch.equal(g, w), name
    assert all(n == 0 for n in K.launch_counts().values())
    assert set(SCK.launch_counts()) == set(SCREENED)


@pytest.mark.parametrize("ignore_model_err", [False, True])
@pytest.mark.parametrize("nfilt", [2, 5, 20])
def test_screened_brackets_equal_the_pair_and_seed_bounds_above(
        nfilt, ignore_model_err):
    """With the glue's seed (anchors and home tile), screened pass A
    skips only subtiles that cannot move a bracket: its brackets are the
    two-pass pair's exactly, and the seed is never below `above`."""
    srt = _screened_problem(nfilt, ignore_model_err=ignore_model_err)
    args = (srt.d, srt.de, srt.mT, srt.meT)
    c0 = nfilt - 2.0
    seed = torch.minimum(srt.seed, SCK.screen_seed(
        *args, srt.start, width=srt.tm, c0=c0,
        ignore_model_err=ignore_model_err))
    got = SCK.chi2_brackets_screened(*args, srt.bounds, seed, c0=c0,
                                     sm=srt.sm,
                                     ignore_model_err=ignore_model_err)
    want = FM.chi2_brackets(*args, c0=c0, ignore_model_err=ignore_model_err)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((seed >= want[1]).all())
    # ... and the gate skipped something (at F = 20 two sorted filters
    # of twenty bound too little to skip here).
    run = SCK.block_any(srt.bounds <= seed[None, :], SCK.TB)
    assert nfilt == 20 or float(run.float().mean()) < 1.0


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity",
                                 "index_dtype", "absorb_pair", "sm"])
@pytest.mark.parametrize("name", SCREENED)
def test_screened_wrappers_check_their_inputs(name, bad):
    srt = _screened_problem()
    args = [srt.d, srt.de, srt.mT, srt.meT]
    B = srt.d.shape[0]
    S, nb = srt.bmin.shape
    f = torch.zeros(B)
    visit = torch.zeros((nb, S), dtype=torch.int32)
    ph = torch.zeros(B, dtype=torch.int32)
    kw = dict(sm=srt.sm)
    if bad == "dtype":
        args[0], err = args[0].double(), TypeError
    elif bad == "shape":
        args[1], err = args[1][:-1], ValueError
    elif bad == "contiguity":
        args[2], err = args[2].T.contiguous().T, ValueError
    elif bad == "index_dtype":
        visit, ph, err = visit.long(), ph.long(), TypeError
        srt.start = srt.start.long()
    elif bad == "absorb_pair":
        ph, err = None, ValueError
    else:
        kw, err = dict(sm=0), ValueError
    if name == "screen_seed":
        if bad in ("absorb_pair", "sm"):
            err, kw = ValueError, dict(width=0)
        else:
            kw = dict(width=srt.tm)
        call = lambda: SCK.screen_seed(*args, srt.start, c0=3.0, **kw)  # noqa: E731
    elif name == "chi2_brackets_screened":
        if bad in ("index_dtype", "absorb_pair"):
            f, err = f.double(), TypeError
        call = lambda: SCK.chi2_brackets_screened(  # noqa: E731
            *args, srt.bounds, f, c0=3.0, **kw)
    else:
        call = lambda: SCK.chi2_stack_screened(  # noqa: E731
            *args, srt.G, f, srt.bounds, visit, f, f, ph, f, a1=1.5, **kw)
    with pytest.raises(err):
        call()


def test_screened_passes_pad_model_rows_for_bulk_copies():
    """Passes A and B stage model rows by 16-byte bulk copies: the
    wrapper's padded copies hold the rows unchanged (zeros past M), the
    plain versions give the same results on the padded rows' views, and
    on the card a subtile must be a multiple of 4 models."""
    srt = _screened_problem(M=701, sm=128, tm=256)
    mT, meT, ld = SCK._bulk_rows(srt.mT, srt.meT)
    assert ld == 704 and mT.shape == (5, 704) and meT.shape == (5, 704)
    assert torch.equal(mT[:, :701], srt.mT) and not mT[:, 701:].any()
    assert torch.equal(meT[:, :701], srt.meT) and not meT[:, 701:].any()
    want = _screened_calls(srt, plain=True)
    srt.mT, srt.meT = mT[:, :701], meT[:, :701]
    got = _screened_calls(srt, plain=True)
    for name in SCREENED:
        for g, w in zip(got[name], want[name]):
            assert torch.equal(g, w), name
    aligned = _screened_problem(M=700)
    assert SCK._bulk_rows(aligned.mT, aligned.meT) == (aligned.mT,
                                                       aligned.meT, 700)
    cuda = torch.device("cuda")
    assert SCK._check_blocks(SCK.TB, 8, 701, cuda, bulk=True) == 88
    assert SCK._check_blocks(SCK.TB, 6, 701, cuda) == 117
    with pytest.raises(ValueError, match="multiple of 4"):
        SCK._check_blocks(SCK.TB, 6, 701, cuda, bulk=True)


def _screened_card_check(srt, **kw):
    """The three wrappers on the card against their plain versions on
    the same inputs: seed and brackets within 1 ulp, s 1e-5 relative,
    PDFs 1e-5 of each row's largest value."""
    K.reset_launch_counts()
    got = _screened_calls(srt, **kw)
    want = _screened_calls(srt, plain=True, **kw)
    torch.cuda.synchronize()
    assert SCK.launch_counts() == {n: 1 for n in SCREENED}
    _assert_within_ulp(got["screen_seed"][0], want["screen_seed"][0])
    for g, w in zip(got["chi2_brackets_screened"],
                    want["chi2_brackets_screened"]):
        _assert_within_ulp(g, w)
    pdf, s = got["chi2_stack_screened"]
    pdf_w, s_w = want["chi2_stack_screened"]
    torch.testing.assert_close(s, s_w, rtol=1e-5, atol=0)
    scale = pdf_w.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    torch.testing.assert_close(pdf / scale, pdf_w / scale, rtol=0,
                               atol=1e-5)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("ignore_model_err", [False, True])
@pytest.mark.parametrize("F,B,M,Ngrid,sm,tm", [
    (5, 70, 700, 77, 128, 256),
    (5, 1000, 9937, 301, 512, 512),
    (2, 40, 1000, 513, 256, 512),
    (8, 33, 700, 301, 128, 128),
    (20, 70, 3000, 301, 512, 512),
    # M % 4 != 0 and M < sm (one ragged subtile), one grid column, F = 1.
    (1, 45, 99, 1, 128, 128),
    # Ragged M, B and subtiles; past 320 columns (two CTA columns).
    (5, 77, 1003, 513, 256, 512),
    (20, 100, 2001, 1, 512, 512),
    (2, 31, 4099, 77, 512, 1024),
])
def test_screened_kernels_match_plain_on_card(cuda_device, F, B, M, Ngrid,
                                              sm, tm, ignore_model_err):
    srt = _screened_problem(F, B=B, M=M, Ngrid=Ngrid, sm=sm, tm=tm,
                            ignore_model_err=ignore_model_err,
                            device=cuda_device)
    for wt_thresh, absorb in ((1e-3, True), (None, False)):
        _screened_card_check(srt, ignore_model_err=ignore_model_err,
                             wt_thresh=wt_thresh, absorb=absorb)


@pytest.mark.gpu
@pytest.mark.parametrize("gates", ["closed", "open"])
@pytest.mark.parametrize("F,B,M,Ngrid", [(5, 70, 700, 301), (1, 45, 99, 1),
                                         (20, 77, 1003, 513)])
def test_screened_kernels_with_every_gate_closed_or_open_on_card(
        cuda_device, gates, F, B, M, Ngrid):
    """NaN bounds close every gate (nothing runs: brackets -1 / +inf, s
    and pdf 0); -inf bounds open every one (the run-all operand)."""
    srt = _screened_problem(F, B=B, M=M, Ngrid=Ngrid, sm=128, tm=256,
                            device=cuda_device)
    srt.bounds = torch.full_like(srt.bounds,
                                 torch.nan if gates == "closed"
                                 else -torch.inf)
    got = _screened_card_check(srt)
    if gates == "closed":
        below, above = got["chi2_brackets_screened"]
        assert bool((below == -1.0).all()) and bool((above == torch.inf).all())
        assert not got["chi2_stack_screened"][0].any()
        assert not got["chi2_stack_screened"][1].any()


@pytest.mark.gpu
@pytest.mark.parametrize("wt_thresh", [1e-3, None])
@pytest.mark.parametrize("absorb", [True, False])
@pytest.mark.parametrize("M,B,F,Ngrid", [(20_000, 3_000, 5, 301),
                                         (1_003, 77, 1, 1),
                                         (99, 45, 2, 77),
                                         (4_099, 500, 20, 513)])
def test_screened_route_equals_run_all_on_card(cuda_device, wt_thresh,
                                               absorb, M, B, F, Ngrid):
    """Every skip exact on the card: the screened route equals its
    run-all twin bit for bit, and its lmap the two-pass pair's."""
    rng = np.random.default_rng(47)
    m = rng.uniform(1, 10, (M, F)).astype(np.float32)
    d = (m[rng.integers(0, M, B)] + rng.normal(0, 0.25, (B, F))).astype(
        np.float32)
    d[:5] = 1e6
    G = TK.kernel_matrix(rng.uniform(0, 3, M), np.full(M, 0.1),
                         np.linspace(0, 3, Ngrid), device="cpu",
                         dx=None if Ngrid > 1 else 0.1).to(torch.float32)
    t = [torch.from_numpy(x).to(cuda_device) for x in (
        d, np.full((B, F), 0.25, np.float32), np.ones((B, F), np.float32),
        m, (0.05 * m).astype(np.float32), np.ones_like(m))]
    t.append(G.contiguous().to(cuda_device))
    kw = dict(wt_thresh=wt_thresh, screen_absorb=absorb)
    K.reset_launch_counts()
    scr = TF.fused_fit_pdf(*t, screen_stats=True, **kw)
    assert SCK.launch_counts() == {n: 1 for n in SCREENED}
    ra = TF.fused_fit_pdf(*t, screen_run_all=True, **kw)
    for a, b in zip(scr[:3], ra):
        assert torch.equal(a, b)
    if M == 20_000:
        assert float(scr[3][1]) < 1.0  # pass B skipped something
    k1 = TF.fused_fit_pdf(*t, screen=False, wt_thresh=wt_thresh)
    assert torch.equal(scr[1], k1[1])
    torch.testing.assert_close(scr[2], k1[2], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(scr[0], k1[0], rtol=2e-3, atol=2e-5)


@pytest.mark.gpu
def test_expf_flushes_below_the_underflow_cut_on_card(cuda_device):
    """The underflow cut's premise on the card: the kernels' expf, and
    torch.exp there, return exactly 0.0 at and below LN_W_UNDERFLOW."""
    lo = np.float32(-110.0).view(np.int32)
    hi = np.float32(SC.LN_W_UNDERFLOW).view(np.int32)
    x = torch.from_numpy(np.arange(hi, lo + 1, dtype=np.int64).astype(
        np.int32).view(np.float32)).to(cuda_device)
    assert bool((SCK.expf_probe(x) == 0).all())
    assert bool((torch.exp(x) == 0).all())
