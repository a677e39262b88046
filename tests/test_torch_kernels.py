"""The full-mask CUDA kernels' wrappers, plain versions and counters.

This file imports neither JAX nor `frankenz_tpu`, so it also runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels.py

Tests marked `gpu` hold each CUDA kernel against its plain version on
the card and skip without one.  Tolerances there: chi^2 brackets 2e-7
relative (the kernel and the plain version round every operation in the
same order: expected bit-equal); weight sums and PDFs 1e-5 relative
(the same weights, summed in another order).
"""

import numpy as np
import pytest
import torch

from frankenz_tpu_torch.kernels import fullmask as FM
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


# ---------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------


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
    masked[:, 0] = 0.0
    with pytest.raises(NotImplementedError, match="K3"):
        gpu_bf.fit_predict(args[0], args[1], masked, *args[3:], **kw)
