"""Nothing the benchmark runs loads JAX or the JAX package (whole
top-level names: `frankenz_tpu_torch` is not `frankenz_tpu`), and the
reference loads nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest

import bench_util
from fzbench import cell

HARNESS = sorted(p for p in bench_util.BENCH.rglob("*.py")
                 if "tests" not in p.parts)
PROGRAM_FREE = ("reference.py", "compare.py", "traffic.py", "window.py",
                "spec.py", "work.py", "peaks.py", "layers.py", "survey.py")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.startswith("frankenz_tpu."):
            yield "frankenz_tpu"


def test_forbidden_names_are_whole_names():
    assert cell.forbidden_modules(["frankenz_tpu_torch.ops", "jaxtyping",
                                   "numpy"]) == []
    assert cell.forbidden_modules(["jax.numpy", "frankenz_tpu.ops",
                                   "flax"]) == ["flax", "frankenz_tpu", "jax"]


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: p.name)
def test_no_source_imports_jax(path):
    names = set(_imports(path))
    assert not names & set(cell.FORBIDDEN)
    if path.name in PROGRAM_FREE:
        assert "frankenz_tpu_torch" not in names


def _loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, cwd=bench_util.ROOT, timeout=600).stdout
    return set(json.loads(out.splitlines()[-1]))


PRELUDE = (f"import sys, json; sys.path[:0] = [{str(bench_util.BENCH)!r}, "
           f"{str(bench_util.ROOT)!r}]\n")
REPORT = "\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"


def test_reference_loads_nothing_of_the_program():
    names = _loaded(PRELUDE + "import fzbench.reference, fzbench.compare, "
                    "fzbench.traffic, fzbench.window" + REPORT)
    assert not names & {"frankenz_tpu_torch", *cell.FORBIDDEN}


def test_a_run_loads_no_jax():
    """A whole run on the CPU, the port and its plain kernels included."""
    code = (PRELUDE + "import bench_util\nfrom fzbench import cell\n"
            "c = bench_util.tiny_cell('hsc-bf.masked')\n"
            "res = cell.run(c, 99, 0.3, device='cpu')\n"
            "assert res['correct'], res" + REPORT)
    code = code.replace(PRELUDE, PRELUDE + "sys.path.insert(0, "
                        f"{str(bench_util.BENCH / 'tests')!r})\n")
    names = _loaded(code)
    assert "frankenz_tpu_torch" in names
    assert not names & set(cell.FORBIDDEN)


def test_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only the benchmark's files, `run.py`
    exits non-zero and prints no result."""
    import shutil

    shutil.copytree(bench_util.BENCH, tmp_path / "benchmark")
    shutil.copy(bench_util.ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "hsc-bf.full",
         "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
        text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                     "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
