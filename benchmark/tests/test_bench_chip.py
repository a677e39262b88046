"""A short run of each one-card cell on the card (skips without one):

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu \\
        benchmark/tests/test_bench_chip.py
"""

import json
import subprocess
import sys

import pytest

import bench_util
from fzbench import spec

ONE_CARD = [w["name"] for w in spec.benchmark()["workloads"]
            if w["chips"] == 1]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ONE_CARD)
def test_short_run_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2718281828459", "--seconds", "2", "--trace", "1"],
        cwd=bench_util.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    c = spec.Cell(name)
    assert set(res["metrics"]) == {m["name"] for m in c.per_layer}
    for key, m in res["metrics"].items():
        if "roofline" in key:
            assert 0 < m["value"] <= 100
