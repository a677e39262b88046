"""The roofline's counts: hand-worked numbers at a tiny shape, and a
count that does not depend on the route that serves the call."""

import numpy as np
import pytest

import bench_util
from fzbench import cell, compare, peaks, spec, traffic, window

CONFIG = {"models": {"n": 4}, "grid": {"n": 5}}
MASK = np.array([[1, 1, 1], [1, 0, 1]], np.float32)


def test_fixed_scale_count_by_hand():
    ref = {"kept": np.array([2.0, 1.0]), "kept_nnz": np.array([6.0, 3.0])}
    ops, nbytes = spec.counter("fixed_scale")(MASK, CONFIG, ref)
    # Pairs: 4 models x (5 x 5 observed bands + 9 x 2 rows) = 172; the
    # stack: 2 rows x (mean(2 x [6, 3] + 2 x [2, 1]) + 2 x 5) = 44.
    assert ops == 216
    # 4 bytes x (catalog 3x2x3 + models 3x4x3 + G 4x5 + PDFs 2x5 + 2x2).
    assert nbytes == 352


def test_free_scale_count_by_hand():
    ref = {"kept": np.array([2.0, 1.0]), "kept_nnz": np.array([6.0, 3.0]),
           "sweeps": np.array([3.0, 5.0]), "observed": np.array([3.0, 3.0])}
    full = np.ones_like(MASK)
    ops, nbytes = spec.counter("free_scale")(full, CONFIG, ref)
    # A row: sweeps x (17 x 3 + 6) -> 171 and 285, mean 228; 4 models x 2
    # rows x (228 + 9) = 1896; the stack as above, 44.
    assert ops == 1940
    assert nbytes == 352


def test_least_time_at_the_peaks():
    kind = "NVIDIA H100 80GB HBM3"
    assert peaks.least_time(67e12, 1.0, kind) == (1.0, "operations")
    assert peaks.least_time(1.0, 3.35e12, kind) == (1.0, "bytes")
    assert peaks.least_time(1.0, 1.0, "cpu") is None


def test_full_mask_count_is_the_same_on_either_route(monkeypatch):
    """The screened route and the two-pass pair (``screen=False``) run
    different kernels over different pairs.  The same four calls through
    either pass the check, and the count, which takes only the inputs and
    the reference's weights, is one number."""
    from frankenz_tpu_torch.ops import fused

    c = bench_util.tiny_cell("hsc-bf.full")
    count = spec.counter(c.config["count"])
    real = fused.fused_fit_pdf
    counts, routes = [], []
    for screen in (True, False):
        def patched(*a, screen_=screen, **k):
            routes.append(fused.fused_route(full_mask=True, screen=screen_))
            return real(*a, **dict(k, screen=screen_))

        monkeypatch.setattr(fused, "fused_fit_pdf", patched)
        dep = traffic.Deployment(c.config, c.traffic, 4242, "cpu")
        prog = cell.Program(c, dep, ["cpu"])
        sample = window.Sample(4242, c.traffic["sample_rows"])
        for k in range(4):
            sample.add(k, k, prog.call(k)[0])
        ref, _ = cell.reference_rows(c, 4242, "cpu", sample)
        values = compare.readings((sample.pdf, sample.lmap, sample.levid),
                                  ref)
        assert compare.judge(values, c.limits)[0], values
        counts.append([count(ch[2], c.config, ref) for ch in dep.chunks])
    assert set(routes) == {"screened", "fullmask"}
    assert counts[0] == counts[1]
    rows = c.traffic["objects_per_call"]
    assert counts[0][0][0] > bench_util.TINY_MODELS * rows * (5 * 5 + 9)


@pytest.mark.parametrize("name", ["hsc-bf.full", "hsc-bf.masked"])
def test_count_reads_observed_bands(name):
    c = spec.Cell(name)
    count = spec.counter(c.config["count"])
    ref = {"kept": np.zeros(3), "kept_nnz": np.zeros(3)}
    full = np.ones((10, 5), np.float32)
    half = full.copy()
    half[:, :2] = 0
    d_ops = count(full, c.config, ref)[0] - count(half, c.config, ref)[0]
    assert d_ops == 5 * 100_000 * 20
