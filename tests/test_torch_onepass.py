"""Port parity: the one-pass route (`wt_thresh=None, cdf_thresh=None` off
the full-mask dim-prior pair) and its kernel's plain version, against
the JAX package on the CPU.

The port's `lnl_onepass` (its plain version on CPU tensors) replaces
`_make_onepass_kernel` (frankenz_tpu/ops/fused.py:670).  It is held
against JAX's one-pass route, `fused_fit_pdf(..., wt_thresh=None,
interpret=True, tb=8, tm=128)`, on tests/test_fused.py's `problem` (B=24,
M=300, F=5, Ngrid=101, 10% of data and model bands masked): PDFs at
tests/test_fused.py:81-87's rtol 1e-3 / atol 1e-5 and lmap / levid at
the general route's rtol 2e-5 / atol 1e-5 (:58-61); under free scale at
tests/test_fused.py's free-scale tolerances (:145-150 without model
errors, :182-187 with them).  BruteForce without a weight threshold is
held against the JAX fitter at tests/test_torch_bruteforce.py's
tolerances.
"""

import numpy as np
import pytest
import torch

from _torch_port import to_numpy
from frankenz_tpu.models import BruteForce as JaxBruteForce
from frankenz_tpu.ops import fused as JF
from frankenz_tpu.ops import kde as JK
from frankenz_tpu_torch.kernels import general as GK
from frankenz_tpu_torch.ops import fused as TF
from frankenz_tpu_torch.utils import from_jax_bruteforce

NONE = dict(wt_thresh=None, cdf_thresh=None)
FIXED_TOL = dict(gof=dict(rtol=2e-5, atol=1e-5), pdf=dict(rtol=1e-3,
                                                          atol=1e-5))
IME_TOL = dict(gof=dict(rtol=1e-4, atol=1e-4), pdf=dict(rtol=5e-3, atol=5e-5))
ME_TOL = dict(gof=dict(rtol=1e-3, atol=1e-3), pdf=dict(rtol=3e-3, atol=1e-4))


@pytest.fixture(scope="module")
def problem():
    """tests/test_fused.py's `problem`, value for value."""
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


def _full(prob):
    d, de, dm, m, me, mm, G = prob
    return d, de, np.ones_like(dm), m, me, np.ones_like(mm), G


def _both(prob, **kw):
    got = to_numpy(TF.fused_fit_pdf(*prob, tm=128, **NONE, **kw))
    want = to_numpy(JF.fused_fit_pdf(*prob, tb=8, tm=128, interpret=True,
                                     screen=False, band_skip=False,
                                     scale_ltol=1e-4, **NONE, **kw))
    return got, want


def _assert_close(got, want, tol):
    assert got[0].shape == want[0].shape and got[0].dtype == np.float32
    np.testing.assert_allclose(got[1], want[1], **tol["gof"])
    np.testing.assert_allclose(got[2], want[2], **tol["gof"])
    np.testing.assert_allclose(got[0], want[0], **tol["pdf"])


@pytest.mark.parametrize("kw", [dict(), dict(dim_prior=False),
                                dict(ignore_model_err=True),
                                dict(full=True, dim_prior=False)],
                         ids=["masked_dimprior", "masked_normal",
                              "masked_no_model_err", "full_normal"])
def test_onepass_fixed_scale_matches_jax(problem, kw):
    """Fixed scale off the full-mask pair: the K4 kernel's route."""
    kw = dict(kw)
    prob = _full(problem) if kw.pop("full", False) else problem
    assert TF.fused_route(full_mask=prob is not problem,
                          dim_prior=kw.get("dim_prior", True),
                          **NONE) == "onepass"
    got, want = _both(prob, **kw)
    _assert_close(got, want, FIXED_TOL)


@pytest.mark.parametrize("dim_prior", [True, False])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("ignore_model_err", [True, False])
def test_onepass_free_scale_matches_jax(problem, ignore_model_err, masked,
                                        dim_prior):
    """Free scale x {datum-only variance, model errors} x {full, masked}
    x {dim prior, Normal} without a weight threshold (the data are the
    problem's, so the scale iterates little; tests/test_torch_freescale
    holds scaled data)."""
    prob = problem if masked else _full(problem)
    assert TF.fused_route(full_mask=not masked, free_scale=True,
                          **NONE) == "onepass"
    got, want = _both(prob, free_scale=True,
                      ignore_model_err=ignore_model_err, dim_prior=dim_prior)
    _assert_close(got, want, IME_TOL if ignore_model_err else ME_TOL)


def test_onepass_padding_edges(problem):
    """19 x 251 x 77 is ragged against every tile; the port masks the
    edges in-kernel instead of padding."""
    d, de, dm, m, me, mm, G = problem
    prob = (d[:19], de[:19], dm[:19], m[:251], me[:251], mm[:251],
            np.ascontiguousarray(G[:251, :77]))
    got, want = _both(prob)
    assert got[0].shape == (19, 77)
    _assert_close(got, want, FIXED_TOL)


def test_onepass_all_masked_object(problem):
    """A row with no observed band: zero PDF and -inf GOF, as JAX's."""
    d, de, dm, m, me, mm, G = problem
    dm2 = dm.copy()
    dm2[0] = 0.0
    got, want = _both((d, de, dm2, m, me, mm, G))
    assert got[0][0].sum() == 0.0 and got[1][0] == got[2][0] == -np.inf
    _assert_close(got, want, FIXED_TOL)


@pytest.mark.parametrize("flags", [dict(), dict(dim_prior=False),
                                   dict(full_mask=True, dim_prior=False)],
                         ids=["masked", "normal", "full_normal"])
def test_lnl_onepass_plain_follows_its_definition(problem, flags):
    """pdf = exp(lnl - lmap) @ G, lmap = max lnl, levid = log sum exp
    lnl, from the lnl grid; the wrapper on CPU tensors runs the plain
    version and launches nothing; rescaled, the PDF is `lnl_stack`'s with
    every weight kept."""
    from scipy.special import logsumexp

    d, de, dm, m, me, mm, G = problem
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (d, de, dm, m.T, me.T, mm.T, G)]
    lnl = GK.lnl_tile_plain(*t[:6], **flags).double().numpy()
    GK.reset_launch_counts()
    pdf, lmap, levid = GK.lnl_onepass(*t, **flags)
    assert GK.launch_counts()["lnl_onepass"] == 0
    np.testing.assert_array_equal(lmap.numpy(), lnl.max(1))
    np.testing.assert_allclose(levid.numpy(), logsumexp(lnl, axis=1),
                               rtol=1e-6, atol=1e-5)
    want = np.exp(lnl - lnl.max(1, keepdims=True)) @ G.astype(np.float64)
    np.testing.assert_allclose(pdf.numpy(), want, rtol=1e-5, atol=1e-7)
    kept = GK.lnl_stack(*t, lmap, levid, log_thr=-np.inf, **flags)
    np.testing.assert_allclose(
        (pdf * torch.exp(lmap - levid)[:, None]).numpy(), kept.numpy(),
        rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "G"])
def test_lnl_onepass_checks_its_inputs(problem, bad):
    d, de, dm, m, me, mm, G = problem
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (d, de, dm, m.T, me.T, mm.T, G)]
    err = ValueError
    if bad == "dtype":
        t[0], err = t[0].double(), TypeError
    elif bad == "shape":
        t[1] = t[1][:-1]
    elif bad == "contiguity":
        t[3] = t[3].T.contiguous().T
    else:
        t[6] = t[6][:-1]
    with pytest.raises(err):
        GK.lnl_onepass(*t)


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
    jbf = JaxBruteForce(models, (0.05 * models).astype(f32), mmask)
    return dict(jax=jbf, torch=from_jax_bruteforce(jbf, device="cpu"),
                args=(data, np.full((B, F), 0.25, f32), dmask,
                      rng.uniform(0, 3, M), np.full(M, 0.1)),
                kw=dict(label_grid=np.linspace(0, 3, Ngrid), verbose=False,
                        return_gof=True, **NONE))


@pytest.mark.parametrize("jax_fused", [True, False])
def test_bruteforce_without_a_threshold_matches_jax(masked_fit, jax_fused):
    """Masked `fit_predict` keeping every weight: the port's one-pass
    kernel against JAX's one-pass kernel and its XLA path."""
    p = masked_fit
    got = p["torch"].fit_predict(*p["args"], **p["kw"])
    want = p["jax"].fit_predict(*p["args"], use_fused=jax_fused, **p["kw"])
    np.testing.assert_allclose(got[1][0], want[1][0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[1][1], want[1][1], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-3, atol=2e-5)
    assert got[0][7].sum() == 0.0 and got[1][0][7] == -np.inf
    np.testing.assert_allclose(np.delete(got[0].sum(1), 7), 1.0, rtol=1e-5)
