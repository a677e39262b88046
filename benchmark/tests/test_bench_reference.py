"""The plain reference against the port's plain composition on the CPU,
both computing in float64 (the port keeps float64 on that route and
returns float32 host arrays), at a tiny size: the same semantics written
twice, equal to the last float32 rounding."""

import math

import numpy as np
import pytest
import torch

import bench_util
from fzbench import compare, reference, traffic


@pytest.mark.parametrize("name,p_missing", [("hsc-bf.full", 0.0),
                                            ("hsc-bf.masked", 0.15),
                                            ("tmpl-free.full", 0.0)])
def test_reference_is_the_plain_composition(name, p_missing):
    from frankenz_tpu_torch.models import BruteForce
    from frankenz_tpu_torch.ops.kde import PDFDict

    c = bench_util.tiny_cell(name, objects=192)
    c.config["models"]["n"] = 1_500
    dep = traffic.Deployment(c.config, c.traffic, 31, "cpu")
    d, de, dm = dep.chunks[0]
    assert abs(1.0 - dm.mean() - p_missing) < 0.05
    m64 = [t.to(torch.float64) for t in dep.model_arrays()]
    bf = BruteForce(*m64, device="cpu")
    fit = c.config["fit"]
    pdf, (lmap, levid) = bf.fit_predict(
        d.astype(np.float64), de.astype(np.float64), dm.astype(np.float64),
        dep.labels, dep.label_errs,
        label_dict=PDFDict(dep.grid, dep.sigmas, dep.sigma_trunc),
        lprob_kwargs=fit["lprob_kwargs"], wt_thresh=fit["wt_thresh"],
        return_gof=True, verbose=False, use_fused=False)
    ref = reference.Reference(c.config, *m64, dep.labels, dep.label_errs,
                              dep.grid, dep.sigmas, dep.sigma_trunc, "cpu",
                              block=64).rows(d, de, dm)
    np.testing.assert_allclose(lmap, ref["lmap"], rtol=1.2e-7, atol=0)
    np.testing.assert_allclose(levid, ref["levid"], rtol=1.2e-7, atol=0)
    assert compare.pdf_gap(pdf, ref["pdf"], ref["pdf"]) < 2.4e-7
    if "free" in name:
        assert ref["sweeps"].min() >= 2


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0e-5,
                      float("inf")])
    got = reference.round_tf32(x)
    # Ties go to even: 1 + 2^-11 -> 1, 1 + 3 x 2^-11 -> 1 + 2^-9.
    assert got.tolist()[:3] == [1.0, 1.0, 1.0 + 2 ** -9]
    assert abs(got[3] / x[3] - 1) < 2 ** -11
    assert got[4] == float("inf")


def test_envelope_takes_either_side_of_the_cut():
    """A weight near the cut may be kept or not: both PDFs fall inside
    the envelope; a PDF off by more than roundoff does not."""
    ref_lo = np.array([[0.5, 0.5, 0.0]])
    ref_hi = np.array([[0.5, 0.5, 0.01]])
    assert compare.pdf_gap(np.array([[0.5, 0.5, 0.005]]), ref_lo, ref_hi) \
        == 0
    assert compare.pdf_gap(np.array([[0.5, 0.48, 0.0]]), ref_lo, ref_hi) \
        == pytest.approx(0.04)
    assert compare.pdf_gap(np.array([[0.1, 0.0, 0.0]]), np.zeros((1, 3)),
                           np.zeros((1, 3))) == float("inf")
    assert compare.gof_gap([-np.inf, 2.0], [-np.inf, 2.0]) == 0
    assert compare.gof_gap([1.0, 2.0], [-np.inf, 2.0]) == float("inf")


def test_exact_match_on_one_band_takes_the_floor():
    """A datum equal to a model's flux to the last bit on its one
    observed band: the chi^2 density with one degree of freedom is
    infinite at 0.  The reference floors chi^2 in the log term as the
    fitter's fused route does, so the pair's weight is finite and the
    PDF is that model's kernel row."""
    from frankenz_tpu_torch.models import BruteForce
    from frankenz_tpu_torch.ops.kde import PDFDict

    c = bench_util.tiny_cell("hsc-bf.masked", objects=64)
    dep = traffic.Deployment(c.config, c.traffic, 5, "cpu")
    d, de, dm = (a.copy() for a in dep.chunks[0])
    m = dep.models.numpy()
    dm[5] = 0
    dm[5, 0] = 1
    d[5, 0] = m[17, 0]
    pdf, (lmap, levid) = BruteForce(*dep.model_arrays(), device="cpu") \
        .fit_predict(d, de, dm, dep.labels, dep.label_errs,
                     label_dict=PDFDict(dep.grid, dep.sigmas,
                                        dep.sigma_trunc),
                     return_gof=True, verbose=False)
    ref = reference.Reference(c.config, *dep.model_arrays(), dep.labels,
                              dep.label_errs, dep.grid, dep.sigmas,
                              dep.sigma_trunc, "cpu").rows(d, de, dm)
    floor = -0.5 * np.log(1e-30) - (math.lgamma(0.5) + 0.5 * math.log(2))
    assert ref["lmap"][5] == pytest.approx(floor, rel=1e-12)
    assert compare.readings((pdf, lmap, levid), dict(
        ref, pdf_lo=ref["pdf"], pdf_hi=ref["pdf"]))["lmap_gap"] < 1e-6
    assert np.argmax(ref["pdf"][5]) == np.argmax(pdf[5])
