#!/usr/bin/env python3
"""Run one cell of the benchmark of `frankenz_tpu_torch` on this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout: the cells are `BENCHMARK.json`'s
``workloads``.  It needs as many CUDA cards as the cell asks for, and
exits non-zero, printing no result, without them, when the checkout's
`frankenz_tpu_torch` is missing, or when JAX or the JAX package was
loaded.  The last line of standard output is the result (JSON); the
last lines of standard error name each number the output check compared,
with its limit.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _caches():
    """Every compiler cache in fixed directories inside the checkout (the
    port's own build directory is fixed already: build/frankenz_tpu_torch)."""
    base = ROOT / "build" / "benchmark"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()
    sys.path[:0] = [str(BENCH), str(ROOT)]
    marks = [time.perf_counter()]
    import torch

    marks.append(time.perf_counter())
    from fzbench import cell, spec

    c = spec.Cell(args.workload)
    import frankenz_tpu_torch

    marks.append(time.perf_counter())

    if ROOT not in Path(frankenz_tpu_torch.__file__).resolve().parents:
        print(f"frankenz_tpu_torch comes from {frankenz_tpu_torch.__file__}, "
              f"not from this checkout ({ROOT})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < c.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {c.chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    marks.append(time.perf_counter())
    print(f"imports: torch {marks[1] - marks[0]:.3f} s, the harness and "
          f"frankenz_tpu_torch {marks[2] - marks[1]:.3f} s, the card check "
          f"{marks[3] - marks[2]:.3f} s", file=sys.stderr)
    result = cell.run(c, args.seed, args.seconds, trace=bool(args.trace),
                      t0=T0)
    from fzbench import peaks

    for line in peaks.power_limits():
        print(f"card: {line}", file=sys.stderr)
    found = cell.forbidden_modules()
    if found:
        print(f"loaded during the run: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, chk in result["checks"].items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r}",
              file=sys.stderr)
    print(json.dumps(_finite(result)), flush=True)
    return 0


def _finite(x):
    """The result with non-finite numbers as null (strict JSON); standard
    error names them."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())
