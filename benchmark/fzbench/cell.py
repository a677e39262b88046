"""One run of one cell: set-up, the measured window, the output check and
the result line.

Set-up (timed as ``setup_s``, from the process start to the first timed
call): the port's import and kernel build (its fixed directory
``build/frankenz_tpu_torch/`` inside the checkout), the inputs from the
seed, the fitter and one warm call on the cell's own shapes.  The window
then calls ``BruteForce.fit_predict(..., return_gof=True)`` on the
chunks in turn until ``--seconds`` have passed, each call a chunk of the
catalog returned to the host.  With ``trace`` the same window runs under
the profiler and the per-layer metrics are read from it.  Once the window
has closed and its memory peak is read, the program's state is freed and
the reference recomputes the sampled rows from the seed.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from . import compare, layers, peaks, spec
from . import trace as tr
from . import traffic as tf
from .reference import Arith, Reference
from .window import Sample, Window

FORBIDDEN = ("jax", "jaxlib", "flax", "frankenz_tpu")


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that the benchmark must not load
    (whole names: `frankenz_tpu_torch` is not `frankenz_tpu`)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def _devices(torch, device, n):
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def _sync(torch, devices):
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _peak(torch, devices):
    """The allocator's peak on the fullest card (None off the card)."""
    if devices[0].type != "cuda":
        return None
    return max(int(torch.cuda.max_memory_allocated(d))
               for d in dict.fromkeys(devices))


def _reset_peak(torch, devices):
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)


class Program:
    """The system under test: the fitter over a deployment's models and
    the call the window repeats."""

    def __init__(self, cell, dep, devices):
        from frankenz_tpu_torch.models import BruteForce
        from frankenz_tpu_torch.ops.kde import PDFDict
        from frankenz_tpu_torch.parallel import make_mesh

        self.dep = dep
        self.fitter = BruteForce(*dep.model_arrays(), device=devices[0])
        fit = cell.config["fit"]
        self.kw = dict(
            label_dict=PDFDict(dep.grid, dep.sigmas, dep.sigma_trunc),
            return_gof=True, verbose=False,
            batch_size=int(cell.traffic["batch_size"]),
            wt_thresh=float(fit["wt_thresh"]),
            lprob_kwargs=dict(fit.get("lprob_kwargs", {})))
        if len(devices) > 1:
            self.kw["mesh"] = make_mesh(devices=devices)

    def call(self, k):
        """Call `k` of the window: (outputs, objects)."""
        chunk = self.dep.chunks[k % len(self.dep.chunks)]
        out = self.fitter.fit_predict(*chunk, self.dep.labels,
                                      self.dep.label_errs, **self.kw)
        return out, len(chunk[0])


def reference_rows(cell, seed, device, sample, arith=Arith("float64"),
                   flip_band=None):
    """The reference's answers for the sampled rows, from the seed's
    inputs made anew, and its readings for the roofline count."""
    dep = tf.Deployment(cell.config, cell.traffic, seed, device)
    ref = Reference(cell.config, *dep.model_arrays(), dep.labels,
                    dep.label_errs, dep.grid, dep.sigmas, dep.sigma_trunc,
                    device, arith=arith)
    band = compare.FLIP_BAND_NATS if flip_band is None else flip_band
    n = len(sample.lmap)
    out = {}
    for c in range(len(dep.chunks)):
        pos, rows = sample.rows_of(c)
        if not len(pos):
            continue
        chunk = dep.chunks[c]
        got = ref.rows(*(a[rows] for a in chunk), flip_band=band)
        got["observed"] = chunk[2][rows].sum(axis=1)
        for key, val in got.items():
            if key not in out:
                out[key] = np.zeros((n,) + val.shape[1:], val.dtype)
            out[key][pos] = val
    return out, dep


def _least_time(cell, dep, calls, ref, kind):
    """Mean least time of the traced calls' work at the card's peaks."""
    count = spec.counter(cell.config["count"], cell.bench_dir)
    times = []
    for k in range(calls):
        mask = dep.chunks[k % len(dep.chunks)][2]
        got = peaks.least_time(*count(mask, cell.config, ref), kind)
        if got is None:
            return None
        times.append(got[0])
    return float(np.mean(times)) if times else None


def run(cell, seed, seconds, trace=False, device="cuda", t0=None,
        log=sys.stderr, keep=None):
    """One run; returns the result line's dict (``checks`` last), or
    raises.  `t0`: the process start on `time.perf_counter`'s clock;
    `keep`: a dict that receives the sample and the reference's rows."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = int(cell.traffic.get("mesh", 1))
    devices = _devices(torch, device, mesh)
    marks = [("imports", time.perf_counter())]
    dep = tf.Deployment(cell.config, cell.traffic, seed, devices[0])
    marks.append(("inputs", time.perf_counter()))
    prog = Program(cell, dep, devices)
    marks.append(("fitter", time.perf_counter()))
    prog.call(0)
    _sync(torch, devices)
    marks.append(("warm call", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    print("set-up: " + ", ".join(
        f"{name} {t - prev:.3f} s" for (name, t), prev in
        zip(marks, [t0] + [t for _, t in marks[:-1]])), file=log)

    sample = Sample(seed, int(cell.traffic["sample_rows"]))
    win = Window(seconds)

    def timed(k):
        with torch.profiler.record_function(tr.CALL_SPAN):
            return prog.call(k)

    def add(k, out):
        sample.add(k, k % len(dep.chunks), out)

    setup_peak = _peak(torch, devices)
    _reset_peak(torch, devices)
    summary = None
    if trace:
        with tr.profiled() as events:
            win.run(timed, on_result=add)
        summary = tr.summarize(events)
        del events
    else:
        win.run(timed, on_result=add)
    peak_window = _peak(torch, devices)
    kind = (torch.cuda.get_device_name(devices[0])
            if devices[0].type == "cuda" else "cpu")
    memory_peak = (None if peak_window is None
                   else max(setup_peak, peak_window))
    del prog, dep
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()

    if sample.lmap is not None and len(sample.lmap):
        ref, dep = reference_rows(cell, seed, devices[0], sample)
        values = compare.readings((sample.pdf, sample.lmap, sample.levid),
                                  ref)
    else:
        ref, dep, values = None, None, {}
    if keep is not None:
        keep.update(sample=sample, ref=ref, rate=win.rate, setup_s=setup_s,
                    attempted=win.attempted)
    ok, checks = compare.judge(values, cell.limits)
    correct = bool(ok and win.failed == 0 and win.attempted > 0)

    least = None
    if trace and summary is not None and ref is not None:
        least = _least_time(cell, dep, summary["calls"], ref, kind)
    ctx = layers.Context(
        win.rate, setup_s, trace=summary,
        device_ids=[d.index if d.index is not None else 0
                    for d in dict.fromkeys(devices)],
        least_s=least, peak_window_bytes=peak_window)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        val = spec.reader(m["name"], cell.bench_dir)(ctx)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    dev = {"platform": "gpu" if devices[0].type == "cuda" else "cpu",
           "kind": kind, "count": len(set(devices)),
           "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if trace and summary is not None:
        print(f"spans not installed: {summary['spans_missing'] or 'none'}; "
              f"installed, never in the trace: "
              f"{summary['spans_unseen'] or 'none'}", file=log)
        busy = [d["busy_s"] for d in ctx.devices()]
        dev["busy_s"] = float(np.mean(busy))
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in summary["device_ops"]],
            "idle_gaps": [[n, s] for n, s in summary["idle_gaps"]]}
    for err in win.errors[:3]:
        print(f"call failed: {err}", file=log)
    if win.attempted:
        dur = np.subtract(win.ends, win.starts)
        print(f"calls: {win.attempted} in {win.span_s:.3f} s; seconds a call "
              f"min {dur.min():.4f} median {np.median(dur):.4f} max "
              f"{dur.max():.4f}; the first {dur[0]:.4f}", file=log)
        print("seconds of each call: " + " ".join(f"{d:.3f}" for d in dur),
              file=log)
    result["checks"] = checks
    return result
