"""Port parity for the photometry transforms, `pdfs_resample` and the
mock-survey simulator (IGM, BPZ priors, MockSurvey, the SDSS mock).

The same NumPy inputs go through `frankenz_tpu` (on the CPU, x64) and the
port (on CPU tensors).  The sampling is host NumPy in both packages, so
one seed draws the same (m, t, template, z) and noise bit for bit; the
synthesis runs in float64 (torch here, XLA there) and is held to 1e-10
relative.  Transforms and IGM: 1e-12 relative in float64.  JAX's catalog
helpers run with ``cache=False``, so nothing is written under
`frankenz_tpu/data/generated/`.
"""

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from frankenz_tpu import sim as JS
from frankenz_tpu.ops import summarize as JSUM
from frankenz_tpu.ops import transforms as JT
from frankenz_tpu_torch import sim as TS
from frankenz_tpu_torch.ops import summarize as TSUM
from frankenz_tpu_torch.ops import transforms as TT

TOL_EXACT = dict(rtol=1e-12, atol=0)
TOL_SYNTH = 1e-10


def rel_err(got, want):
    """Max |got - want| / |want| (absolute where want is 0); non-finite
    entries must sit in the same places with the same values."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    d = np.abs(got[fin] - want[fin])
    s = np.abs(want[fin])
    return float(np.max(np.where(s > 0, d / np.where(s > 0, s, 1), d),
                        initial=0.0))


@pytest.mark.parametrize("name", ["magnitude", "inv_magnitude", "luptitude",
                                  "inv_luptitude"])
@pytest.mark.parametrize("kw", [{}, {"zeropoints": 3.0, "skynoise": 0.4},
                                {"arrays": True}],
                         ids=["default", "scalars", "arrays"])
def test_transforms_match_jax(name, kw):
    rng = np.random.default_rng(1)
    x = rng.normal(5.0, 4.0, (9, 5))
    if name == "magnitude":
        x = np.abs(x) + 0.1
    xe = np.abs(x) * 0.1 + 0.01
    kw = dict(kw)
    if kw.pop("arrays", False):
        kw = {"zeropoints": np.linspace(1.0, 2.0, 5)}
        if "lupt" in name:
            kw["skynoise"] = np.linspace(0.5, 1.5, 5)
    if "lupt" not in name:
        kw.pop("skynoise", None)
    want = getattr(JT, name)(x, xe, **kw)
    got = getattr(TT, name)(x, xe, device="cpu", **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL_EXACT)


def test_transforms_round_trip_and_tensors():
    """Luptitudes and back; tensors stay on their device and dtype."""
    x = torch.tensor([[-3.0, 0.0, 2.0, 50.0]], dtype=torch.float32)
    xe = torch.full_like(x, 0.5)
    mag, mag_err = TT.luptitude(x, xe)
    assert mag.dtype == torch.float32 and mag.device == x.device
    back, back_err = TT.inv_luptitude(mag, mag_err)
    np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(back_err.numpy(), xe.numpy(), rtol=1e-5)


def test_transforms_host_arrays_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.luptitude(np.ones(3), np.ones(3))


@pytest.mark.parametrize("kw", [{}, {"left": 0.1, "right": 0.2,
                                     "renormalize": False}],
                         ids=["default", "fill"])
def test_pdfs_resample_matches_jax(kw):
    rng = np.random.default_rng(2)
    pdfs = rng.random((6, 50))
    old = np.linspace(0.0, 3.0, 50)
    new = np.linspace(-0.5, 3.7, 83)
    want = np.asarray(JSUM.pdfs_resample(pdfs, old, new, **kw))
    got = TSUM.pdfs_resample(torch.tensor(pdfs), old, new, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    # The clamped interpolation that pdfs_summarize uses is unchanged.
    x = torch.tensor(new)[None]
    clamped = TSUM._interp(x, torch.tensor(old), torch.tensor(pdfs[:1]))
    np.testing.assert_array_equal(clamped[0, 0].item(), pdfs[0, 0])
    np.testing.assert_array_equal(clamped[0, -1].item(), pdfs[0, -1])


@pytest.mark.parametrize("z", [0.0, 0.1, 1.0, 3.0, 6.0])
def test_madau_matches_jax(z):
    wave = np.linspace(300.0, 12000.0, 4000)
    np.testing.assert_allclose(
        TS.madau_teff(torch.tensor(wave), z).numpy(),
        np.asarray(JS.madau_teff(wave, z)), **TOL_EXACT)
    np.testing.assert_allclose(
        TS.madau_tau(torch.tensor(wave), z).numpy(),
        np.asarray(JS.madau_tau(wave, z)), rtol=1e-12, atol=1e-15)


def test_madau_broadcasts_over_redshifts():
    wave = torch.linspace(500.0, 9000.0, 300, dtype=torch.float64)
    zs = torch.tensor([[0.2], [2.0], [4.5]], dtype=torch.float64)
    got = TS.madau_teff(wave, zs)
    assert got.shape == (3, 300)
    for i, z in enumerate((0.2, 2.0, 4.5)):
        want = np.asarray(JS.madau_teff(wave.numpy(), z))
        np.testing.assert_allclose(got[i].numpy(), want, **TOL_EXACT)


def test_madau_places_host_arrays():
    wave = np.linspace(500.0, 9000.0, 50)
    got = TS.madau_teff(wave, 2.0, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(JS.madau_teff(wave, 2.0)),
                               **TOL_EXACT)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.madau_teff(wave, 2.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.madau_tau(wave, 2.0)


def test_bpz_prior_tables_equal_jax():
    a, b = JS.BPZPrior.instance(), TS.BPZPrior.instance()
    np.testing.assert_array_equal(b.pz_table, a.pz_table)
    np.testing.assert_array_equal(b.ft_table, a.ft_table)
    ms = np.array([19.0, 21.3, 24.9, 31.0])
    zs = np.array([0.3, 1.7, 2.9, 5.0])
    for t in range(3):
        np.testing.assert_array_equal(TS.bpz_pt_m(t, ms),
                                      JS.bpz_pt_m(t, ms))
        np.testing.assert_array_equal(TS.bpz_pz_tm(zs, t, ms),
                                      JS.bpz_pz_tm(zs, t, ms))
    mg = np.linspace(10, 28, 200)
    np.testing.assert_array_equal(TS.pmag(mg, maglim=23.0),
                                  JS.pmag(mg, maglim=23.0))


@pytest.fixture(scope="module")
def surveys():
    return (JS.MockSurvey("sdss", "cww+", "bpz", seed=7),
            TS.MockSurvey("sdss", "cww+", "bpz", seed=7, device="cpu"))


def test_survey_loading_equals_jax(surveys):
    a, b = surveys
    assert (b.NFILTER, b.ref_filter, b.NTEMPLATE, b.NTYPE) == \
        (a.NFILTER, a.ref_filter, a.NTEMPLATE, a.NTYPE)
    np.testing.assert_array_equal(b.TYPES, a.TYPES)
    np.testing.assert_array_equal(b.TTYPE, a.TTYPE)
    for fa, fb in zip(a.filters, b.filters):
        assert fa["name"] == fb["name"]
        for key in ("depth_mag5sig", "depth_flux1sig", "lambda_eff"):
            assert fb[key] == fa[key], key
        np.testing.assert_array_equal(fb["transmission"],
                                      fa["transmission"])
    for ta, tb in zip(a.templates, b.templates):
        assert (ta["name"], ta["type"]) == (tb["name"], tb["type"])
        np.testing.assert_array_equal(tb["fnu"], ta["fnu"])


@pytest.mark.parametrize("igm", [True, False])
@pytest.mark.parametrize("budget", [1 << 28, 1 << 20],
                         ids=["one_chunk", "chunked"])
def test_synthesize_grid_matches_jax(surveys, igm, budget):
    a, b = surveys
    zs = np.linspace(0.0, 6.0, 41)
    want = a.synthesize_grid(zs, igm=igm, budget_bytes=budget)
    got = b.synthesize_grid(zs, igm=igm, budget_bytes=budget)
    assert got.shape == want.shape == (41, 8, 5)
    assert rel_err(got, want) <= TOL_SYNTH


@pytest.mark.parametrize("igm", [True, False])
@pytest.mark.parametrize("budget", [1 << 28, 1 << 24],
                         ids=["one_chunk", "chunked"])
def test_synthesize_objects_matches_jax(surveys, igm, budget):
    a, b = surveys
    rng = np.random.default_rng(4)
    zs = rng.uniform(0.0, 7.0, 700)
    ts = rng.integers(0, 8, 700)
    want = a.synthesize_objects(zs, ts, igm=igm, budget_bytes=budget)
    got = b.synthesize_objects(zs, ts, igm=igm, budget_bytes=budget)
    assert got.shape == want.shape == (700, 5)
    assert rel_err(got, want) <= TOL_SYNTH


def test_make_mock_draws_equal_jax():
    a = JS.MockSurvey("sdss", "cww+", "bpz", seed=5)
    b = TS.MockSurvey("sdss", "cww+", "bpz", seed=5, device="cpu")
    da = a.make_mock(300, verbose=False)
    db = b.make_mock(300, verbose=False)
    for key in ("refmags", "types", "templates", "redshifts", "phot_err"):
        np.testing.assert_array_equal(db[key], da[key], err_msg=key)
    for key in ("phot_true", "phot_obs"):
        assert rel_err(db[key], da[key]) <= TOL_SYNTH, key
    # The generators are left in the same state.
    assert a.rng.random() == b.rng.random()


def test_sdss_mock_and_model_grid_equal_jax():
    want = JS.make_sdss_mock(nobj=2_000, cache=False)
    got = TS.make_sdss_mock(nobj=2_000, cache=False, device="cpu")
    assert sorted(got) == sorted(want)
    for key in ("types", "templates", "refmags", "redshifts", "phot_err",
                "phot_mask"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key].dtype == want[key].dtype
    # float32 catalog columns: the float64 fluxes agree to 1e-10 before
    # the cast, so the float32 values agree to one rounding.
    np.testing.assert_allclose(got["phot"], want["phot"], rtol=1e-7, atol=0)
    gj = JS.sdss_model_grid(nz=21)
    gt = TS.sdss_model_grid(nz=21, device="cpu")
    for x, y in zip(gt, gj):
        assert x.dtype == y.dtype and x.shape == y.shape
    np.testing.assert_allclose(gt[0], gj[0], rtol=1e-7, atol=0)
    for x, y in zip(gt[1:], gj[1:]):
        np.testing.assert_array_equal(x, y)


def test_simulator_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.MockSurvey("sdss", "cww+", "bpz")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.make_sdss_mock(nobj=10)
