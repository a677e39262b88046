"""Wall times and one `torch.profiler` trace of config 2's fit_predict.

    python -m frankenz_tpu_torch.tools.profile_knn [--out DIR] [--reps N]

Run from the root of a checkout on a machine with a CUDA card.  Config 2
(bench.py:112-160): `make_sdss_mock(113,000, seed=13)` (not cached), a
`NearestNeighbors(K=25, seed=1)` over the first 100,000 objects, and
`fit_predict` over the next 10,000 with a 701-point grid and k=20.  One
4,096-object warm call, `--reps` timed walls (a fresh
``default_rng(7)`` each), then one call under the profiler with the
fitter's stages wrapped in `record_function` ranges (by patching the
module's functions here, not in the package): the query features, the
distance blocks, the top-k, the rest of the search (the union's sorts),
the gathered posterior, the weights and threshold, the gathered KDE.  It
prints the walls, their median, each stage's device time, the device
busy time (kernels and copies) and its share of the profiled wall, and
the heaviest device operations, and writes ``profile_knn.json`` and the
Chrome trace to `--out` (default ``build/profile_knn``).

Before the walls it counts, over the first 512 test objects with
the first batch's draws, the rows where some ensemble's k nearest models
differ from the exact ones (float64, direct form (q - Y)^2): for the
fitter's float32 expanded distance |Y|^2 - 2 q Y^T + |q|^2, for the
float32 direct form, and for the expanded distance with |Y|^2 summed on
the CPU from the same features (against the fitter's, not the exact).
"""

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

NTRAIN, NTEST, NGRID, K, KNN = 100_000, 10_000, 701, 25, 20
LIST_ROWS = 512
STAGES = (("query_features", "NearestNeighbors._query_features"),
          ("distance", "_distances"), ("topk", "_topk_smallest"),
          ("search", "_search"), ("posterior", "_gathered_lprob"),
          ("weights", "_gof_weights"), ("kde", "_gathered_pdf"))


def _device_ms(event):
    dt = getattr(event, "device_time_total", None)
    return (event.cuda_time_total if dt is None else dt) / 1e3


def _self_device_ms(event):
    dt = getattr(event, "self_device_time_total", None)
    return (event.self_cuda_time_total if dt is None else dt) / 1e3


def _knn_sets(dist, k):
    return torch.sort(torch.topk(dist, k, dim=1, largest=False)[1],
                      dim=1)[0]


def list_rows(nn, d, de, rows):
    """Rows where some ensemble's k nearest set differs, per distance
    form (see the module docstring)."""
    import numpy as np

    from ..models import knn as TKNN

    jq = np.random.default_rng(7).normal(np.asarray(d[:rows], float),
                                         np.abs(np.asarray(de[:rows],
                                                           float)))
    q = nn._query_features(jq, de[:rows])
    qsq = (q * q).sum(dim=1, keepdim=True)
    cpu_sq = (nn.features.cpu() ** 2).sum(dim=-1).to(q.device)
    moved = {name: torch.zeros(rows, dtype=torch.bool, device=q.device)
             for name in ("expanded_f32", "direct_f32", "cpu_Ysq")}
    for e in range(nn.K):
        Y = nn.features[e]
        direct = [sum((q[:, f, None].to(dt) - Y[None, :, f].to(dt)) ** 2
                      for f in range(q.shape[1]))
                  for dt in (torch.float64, torch.float32)]
        exact = _knn_sets(direct[0], KNN)
        fitter = _knn_sets(TKNN._distances(q, qsq, Y, nn.features_sqnorm[e],
                                           2), KNN)
        cpu = _knn_sets(TKNN._distances(q, qsq, Y, cpu_sq[e], 2), KNN)
        moved["expanded_f32"] |= (fitter != exact).any(dim=1)
        moved["direct_f32"] |= (_knn_sets(direct[1], KNN)
                                != exact).any(dim=1)
        moved["cpu_Ysq"] |= (cpu != fitter).any(dim=1)
    return {name: int(m.sum()) for name, m in moved.items()}


def _wrap(owner, attr, label, record_function):
    fn = getattr(owner, attr)

    def wrapped(*a, **kw):
        with record_function("knn." + label):
            return fn(*a, **kw)

    setattr(owner, attr, wrapped)


def main(argv=None):
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..models import NearestNeighbors
    from ..models import knn as TKNN
    from ..sim import make_sdss_mock

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile_knn")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)

    cat = make_sdss_mock(nobj=113_000, seed=13, cache=False)
    m, me, mm = (cat[k][:NTRAIN] for k in ("phot", "phot_err", "phot_mask"))
    z = cat["redshifts"][:NTRAIN]
    test = slice(NTRAIN, NTRAIN + NTEST)
    d, de, dm = (cat[k][test] for k in ("phot", "phot_err", "phot_mask"))
    grid = np.linspace(0, 7.0, NGRID)
    nn = NearestNeighbors(m, me, mm, K=K, seed=1, verbose=False)
    lists = list_rows(nn, d, de, LIST_ROWS)
    print(f"== lists: of {LIST_ROWS} rows, some ensemble's k={KNN} "
          f"nearest differ from the float64 exact set: float32 expanded "
          f"(the fitter's) {lists['expanded_f32']}, float32 direct "
          f"{lists['direct_f32']}; the fitter's against |Y|^2 summed on the "
          f"CPU {lists['cpu_Ysq']} | {card}", flush=True)
    kw = dict(label_grid=grid, k=KNN, verbose=False, return_gof=True)
    call = (d, de, dm, z, 0.02 * (1.0 + z))
    nn.fit_predict(*(x[:4096] for x in call[:3]), *call[3:], **kw)
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        nn.fit_predict(*call, rng=np.random.default_rng(7), **kw)
        walls.append(time.perf_counter() - t0)

    for label, name in STAGES:
        owner, attr = ((NearestNeighbors, name.split(".")[1]) if "." in name
                       else (TKNN, name))
        _wrap(owner, attr, label, record_function)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nn.fit_predict(*call, rng=np.random.default_rng(7), **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    stages = {e.key[4:]: (_device_ms(e), e.count) for e in events
              if e.key.startswith("knn.")}
    # `aten::` rows and the ranges repeat the device time of the kernels
    # and copies they launch: left out of the busy sum.
    ops = sorted(((_self_device_ms(e), e.key, e.count) for e in events
                  if _self_device_ms(e) > 0
                  and not e.key.startswith(("aten::", "knn."))),
                 reverse=True)
    busy = sum(op[0] for op in ops)
    med = statistics.median(walls)
    print(f"== config2_fit_predict: {NTEST} objects x {NTRAIN} models, "
          f"K={K}, k={KNN}, {NGRID}-point grid; walls {walls} s, median "
          f"{med} s = {NTEST / med} objects/s; profiled wall {wall_ms} ms, "
          f"device busy {busy} ms, busy share {busy / wall_ms} | {card}",
          flush=True)
    for label, _ in STAGES:
        ms, count = stages.get(label, (0.0, 0))
        print(f"  stage {label:15s} {ms:10.3f} ms  x{count}", flush=True)
    for ms, key, count in ops[:15]:
        print(f"  {ms:10.3f} ms  {100 * ms / busy:6.2f}%  x{count}  "
              f"{key[:90]}", flush=True)
    report = dict(card=card, list_rows=lists, walls_s=walls, median_s=med,
                  profiled_wall_ms=wall_ms, device_busy_ms=busy,
                  stages=stages, ops=ops[:25])
    (out_dir / "profile_knn.json").write_text(json.dumps(report, indent=1))
    prof.export_chrome_trace(str(out_dir / "trace_config2_fit_predict.json"))


if __name__ == "__main__":
    main()
