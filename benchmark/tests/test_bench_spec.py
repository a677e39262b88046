"""`BENCHMARK.json` and the files it names: every cell loads, names an
existing configuration and has a reader for each of its metrics; a new
cell is found by its files alone."""

import json
import re
import shutil

import pytest

import bench_util  # noqa: F401
from fzbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_with_readers(name):
    c = spec.Cell(name)
    assert c.config["name"] == c.entry["config"]
    assert (spec.BENCH_DIR / "counts" / f"{c.config['count']}.py").exists()
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    for m in c.per_layer:
        assert m["moves"] in e2e
    assert set(c.limits) == {"lmap_gap", "levid_gap", "pdf_gap"}
    cfg = spec.config_entry(BENCH, c.entry["config"])
    assert cfg["reduced"] == c.config["reduced"]
    assert cfg["source"] == c.config["source"]


def test_a_new_cell_is_found_by_its_files(tmp_path):
    """A later change adds a workload file and a `BENCHMARK.json` entry,
    and edits nothing: the harness finds the cell and its metrics."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR / "workloads", bench_dir / "workloads")
    shutil.copytree(spec.BENCH_DIR / "metrics", bench_dir / "metrics")
    shutil.copytree(spec.BENCH_DIR / "counts", bench_dir / "counts")
    new = json.loads((bench_dir / "workloads" / "hsc-bf.masked.json")
                     .read_text())
    new["traffic"]["p_missing"] = 0.3
    (bench_dir / "workloads" / "hsc-bf.sparse.json").write_text(
        json.dumps(new))
    (bench_dir / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return 2.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "hsc-bf.sparse", "config": "hsc-bf",
                               "traffic": "sparse", "chips": 1,
                               "why": "more bands missing"})
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "fitter and host I/O",
                               "moves": "objects_per_s",
                               "workloads": ["hsc-bf.sparse"]})
    for m in bench["end_to_end"]:
        if m["name"] == "objects_per_s":
            m["workloads"].append("hsc-bf.sparse")
    c = spec.Cell("hsc-bf.sparse", bench=bench, bench_dir=bench_dir)
    assert c.traffic["p_missing"] == 0.3
    assert [m["name"] for m in c.per_layer] == ["calls_per_s"]
    assert spec.reader("calls_per_s", bench_dir)(None) == 2.0
    assert "objects_per_s" in [m["name"] for m in c.end_to_end]


def test_a_workload_file_that_disagrees_is_refused(tmp_path):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR / "workloads", bench_dir / "workloads")
    path = bench_dir / "workloads" / "hsc-bf.full.json"
    wl = json.loads(path.read_text())
    wl["chips"] = 4
    path.write_text(json.dumps(wl))
    with pytest.raises(ValueError):
        spec.Cell("hsc-bf.full", bench_dir=bench_dir)


def test_one_reader_serves_a_base_name_and_its_variants():
    """``kernel_ms.free`` is read by ``metrics/kernel_ms.py``: a variant
    of a metric for another cell needs no file of its own."""
    assert spec.reader("kernel_ms.free").__code__.co_filename == \
        spec.reader("kernel_ms").__code__.co_filename
    variants = [m["name"] for m in BENCH["per_layer"] + BENCH["end_to_end"]
                if "." in m["name"]]
    assert variants
    for name in variants:
        assert (spec.BENCH_DIR / "metrics"
                / f"{name.split('.')[0]}.py").exists()
