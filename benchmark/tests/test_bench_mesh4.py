"""The four-card cell `hsc-bf.masked-mesh4` on 4 shards of the CPU (its
objects and batch cut to multiples of 4): a sound run is correct under
the cell's own limits and the control (the reference in TF32 in the
program's place) is not; `metrics/stage_mb.py` reads the program's stage
counters."""

import pytest

import bench_util
from fzbench import cell, compare, layers, spec
from fzbench.reference import Arith

NAME = "hsc-bf.masked-mesh4"
SEED = 2 ** 31 + 4242


def test_cell_is_four_shards_of_the_masked_route():
    c = spec.Cell(NAME)
    assert c.chips == 4 and int(c.traffic["mesh"]) == 4
    assert c.traffic["objects_per_call"] % (4 * c.traffic["batch_size"]) == 0
    assert c.traffic["batch_size"] // 4 == spec.Cell(
        "hsc-bf.masked").traffic["batch_size"]
    assert {m["name"] for m in c.per_layer} >= {"stage_mb.masked"}


def test_node_config_is_hsc_bf_on_four_cards():
    """`hsc-bf-node4` is `hsc-bf`'s deployment on a node: the survey, the
    models, the grid, the fit and its count are the same, nothing is cut,
    and its node holds the cell's four cards."""
    node = spec.Cell(NAME).config
    one = spec.Cell("hsc-bf.masked").config
    own = {"name", "deployment", "source", "assumed", "node"}
    assert {k: v for k, v in node.items() if k not in own} == {
        k: v for k, v in one.items() if k not in own}
    assert node["reduced"] == [] and node["source"] != one["source"]
    assert node["node"]["cards"] == spec.Cell(NAME).chips


def test_sound_run_is_correct_and_control_is_not():
    c = bench_util.tiny_cell(NAME, objects=512, batch=256, sample=128)
    assert int(c.traffic["mesh"]) == 4
    kept = {}
    res = cell.run(c, SEED, 0.3, device="cpu", keep=kept)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    ctl, _ = cell.reference_rows(c, SEED, "cpu", kept["sample"],
                                 arith=Arith("tf32"), flip_band=0.0)
    values = compare.readings((ctl["pdf"], ctl["lmap"], ctl["levid"]),
                              kept["ref"])
    ok, table = compare.judge(values, c.limits)
    assert not ok, table


def test_stage_mb_reads_the_program_counters(monkeypatch):
    from frankenz_tpu_torch.utils.metrics import metrics

    read = spec.reader("stage_mb.masked")
    ctx = layers.Context(1.0, 1.0)
    monkeypatch.setattr(metrics, "counters", {})
    assert read(ctx) is None
    monkeypatch.setattr(metrics, "counters", {"fitter.calls": 3})
    assert read(ctx) is None
    # Five calls (the warm call among them) of 630.9 MB each.
    monkeypatch.setattr(metrics, "counters",
                        {"fitter.calls": 5, "stage.bytes": 5 * 630_900_000})
    assert read(ctx) == pytest.approx(630.9)
