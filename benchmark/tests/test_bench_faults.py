"""The output check on whole runs (the chip's look skipped, the port's
plain kernels on the CPU): sound runs pass under each cell's limits; the
control (the reference in TF32 put in the program's place) and each fault
planted under the timed path come out not correct."""

import pytest

import bench_util
from fzbench import cell, compare
from fzbench.reference import Arith

ONE_CARD = ["hsc-bf.full", "hsc-bf.masked", "tmpl-free.full"]
# The harness's path over a mesh of 4 (4 shards of the CPU here), which a
# cell with ``"mesh": 4`` in its traffic takes: the masked cell on it.
MESH = "hsc-bf.masked+mesh4"


def _cell(name):
    if name == MESH:
        c = bench_util.tiny_cell("hsc-bf.masked")
        c.traffic["mesh"] = 4
        return c
    c = bench_util.tiny_cell(name)
    if name.startswith("tmpl-free"):
        c.config["models"]["n"] = 1_000
        c.traffic.update(objects_per_call=128, batch_size=128, sample_rows=64)
    return c


@pytest.mark.parametrize("name", ONE_CARD + [MESH])
def test_sound_run_is_correct_and_control_is_not(name):
    c = _cell(name)
    kept = {}
    res = cell.run(c, 2 ** 31 + 12345, 0.3, device="cpu", keep=kept)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    ctl, _ = cell.reference_rows(c, 2 ** 31 + 12345, "cpu", kept["sample"],
                                 arith=Arith("tf32"), flip_band=0.0)
    values = compare.readings((ctl["pdf"], ctl["lmap"], ctl["levid"]),
                              kept["ref"])
    ok, table = compare.judge(values, c.limits)
    assert not ok, table


def _stale(monkeypatch):
    from frankenz_tpu_torch.models import BruteForce

    real, last = BruteForce.fit_predict, []

    def stale(self, *a, **k):
        if not last:
            last.append(real(self, *a, **k))
        return last[0]

    monkeypatch.setattr(BruteForce, "fit_predict", stale)


def _half(monkeypatch):
    import torch
    from frankenz_tpu_torch.ops import fused

    real = fused.fused_fit_pdf

    def half(d, de, dm, *a, **k):
        n = max(1, d.shape[0] // 2)
        out = real(d[:n], de[:n], dm[:n], *a, **k)
        rest = d.shape[0] - n
        filled = [torch.cat([x, x.mean(0, keepdim=True).expand(
            rest, *x.shape[1:])]) for x in out[:3]]
        return (*filled, *out[3:])

    monkeypatch.setattr(fused, "fused_fit_pdf", half)


def _altered(monkeypatch):
    import torch
    from frankenz_tpu_torch.ops import fused

    real = fused.fused_fit_pdf

    def altered(*a, **k):
        pdf, *rest = real(*a, **k)
        return (torch.roll(pdf, 1, dims=1), *rest)

    monkeypatch.setattr(fused, "fused_fit_pdf", altered)


def _no_exchange(monkeypatch):
    from frankenz_tpu_torch.models import BruteForce

    real, n = BruteForce._finish_shard, [0]

    def first_card_only(host, j0, out, post):
        n[0] += 1
        if n[0] % 4 == 1:
            real(host, j0, out, post)

    monkeypatch.setattr(BruteForce, "_finish_shard",
                        staticmethod(first_card_only))


FAULTS = {"stale": _stale, "half": _half, "altered": _altered}


@pytest.mark.parametrize("name,fault",
                         [(n, f) for n in ONE_CARD for f in FAULTS]
                         + [(MESH, f) for f in FAULTS]
                         + [(MESH, "no_exchange")])
def test_planted_fault_is_not_correct(monkeypatch, name, fault):
    c = _cell(name)
    {**FAULTS, "no_exchange": _no_exchange}[fault](monkeypatch)
    # A stale answer shows from the second call on: give it the time.
    res = cell.run(c, 777, 3.0 if fault == "stale" else 0.5, device="cpu")
    assert res["attempted"] >= (2 if fault == "stale" else 1)
    assert not res["correct"], res["checks"]
