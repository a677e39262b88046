"""What `scale_sweeps` (``csrc/scale_sweeps.cu``) does beyond its time:
the pairs at rest, the SASS instructions of one pair-sweep and the issue
floor they give, and how often a 2-row block of the first design held a
frozen row.  `chip_smoke.py` and `tools/ab_table.py` call these on a
machine with a CUDA card and `nvcc`; nothing here runs at import.

- `start` compiles one source (``csrc/scale_sweeps.cu`` by default) alone
  with extra flags (e.g. ``-DFZ_REST``, the counting build) into its own
  library, with ``-Xptxas -v``; `finish` waits for it and returns the
  compiler's text; `bind` types a library's sweep entry points.
- `launch` calls a library's `fz_scale_sweeps` as the package's wrapper
  does; `same_bits` compares two of its tables.
- `rest_counts` runs a library's `fz_scale_sweeps_rest` around one call
  and `rest_stats` turns its counts into shares: pair-sweeps left out,
  at rest and in 2-cycles (overall and by sweep index), the pair-sweeps
  run (sweep 0 for every pair, then the live list's), fixed 32-slot
  chunks whose pairs had all left, list iterations run against the
  chunks of the loop that updates every pair, and the distribution of k
  per (object, group).
- `report` gives one call's rest statistics, the SASS count of the
  package's list iteration and the issue floor together, and raises when
  any of them cannot be had.
- `pair_waits` reads a sweep table as the first design's blocks of 2 rows
  saw it: the share of blocks whose rows stop at different sweeps, and
  the share of row-sweeps a frozen row sat out.
- `sass_loop` counts, in `cuobjdump -sass` of a library, the instructions
  of the sweep loop's list iteration (32 pair-sweeps, one a lane) of one
  instantiation (`sass_loops`: every loop of a function in cuobjdump's
  text, which tools/ab_fullmask.py reads too); `issue_floor` turns a
  count of iterations into the least time the card's schedulers need to
  issue them.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

REST_WORDS = 517
SOURCE = "scale_sweeps.cu"


def start(build, name, flags, source=None):
    """Start nvcc on `source` (default csrc/scale_sweeps.cu; its directory
    is the include path) with `flags` (and -Xptxas -v) into
    build/frankenz_tpu_torch/libfz_ab_<name>.so; returns (process,
    library path)."""
    src = Path(source) if source else build._SRC_DIR / SOURCE
    out = build.library_path().parent / f"libfz_ab_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.nvcc_path(), *build._NVCC_FLAGS, *flags, "-Xptxas", "-v",
           "-I", str(src.parent), "-shared", "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def finish(proc, what):
    """Wait for a `start`ed build; returns nvcc's output or raises."""
    text = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what}:\n{text}")
    return text


SWEEP_ENTRIES = (
    ("fz_scale_sweeps", ["P"] * 9 + ["I"] * 8 + ["F", "I", "F", "P"]),
    ("fz_scale_sweeps_occupancy", ["I"] * 4),
    ("fz_scale_sweeps_warps", ["I"] * 4),
    ("fz_scale_sweeps_stamps", ["P"]),
    ("fz_scale_sweeps_rest", ["P"]))


def bind(path, extra=()):
    """A library built from scale_sweeps.cu (or the package's) with its
    sweep entry points typed: fz_scale_sweeps and whichever of the
    counters it holds, and `extra` ((name, argument codes) pairs, codes
    "P" pointer, "I" int, "F" float) likewise."""
    lib = ctypes.CDLL(str(path))
    types = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float}
    for name, codes in SWEEP_ENTRIES + tuple(extra):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [types[c] for c in codes]
            getattr(lib, name).restype = ctypes.c_int
    return lib


def launch(lib, args, sweeps, table, *, tm, full_mask, dim_prior,
           ltol=1e-4, max_iter=100):
    """`lib.fz_scale_sweeps` on `args` (d, de, dm, mT, meT, mmT on the
    card) into the int16 (B, groups) `sweeps` and, unless None, the
    (B, table_width(M)) lnl `table`, on the current stream, as
    `kernels.general.scale_sweeps` launches it; raises on a CUDA error."""
    import torch

    from ..kernels import general as GK

    (B, F), M = args[0].shape, args[3].shape[1]
    gl = GK.gl_table(F, args[0].device)
    rc = lib.fz_scale_sweeps(
        *[t.data_ptr() for t in args], gl.data_ptr(), sweeps.data_ptr(),
        None if table is None else table.data_ptr(), GK.table_width(M), B,
        M, F, int(tm), sweeps.shape[1], int(bool(full_mask)),
        int(bool(dim_prior)), float(ltol), int(max_iter), GK._nd_full(F),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fz_scale_sweeps: CUDA error {rc}")


def same_bits(got, want):
    """NaN in the same places and every other entry equal bit for bit
    (float32), or equal (integer tables)."""
    import torch

    if not want.is_floating_point():
        return torch.equal(got, want)
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got.view(torch.int32)[~nan],
                            want.view(torch.int32)[~nan]))


def rest_counts(lib, run):
    """The FZ_REST build's counts over one `run()` (which launches
    `lib.fz_scale_sweeps` and synchronizes)."""
    cnt = (ctypes.c_ulonglong * REST_WORDS)()

    def read():
        rc = lib.fz_scale_sweeps_rest(cnt)
        if rc != 0:
            raise RuntimeError(f"fz_scale_sweeps_rest: CUDA error {rc}")

    read()  # zeroes what earlier launches counted
    run()
    read()
    return list(cnt)


def rest_stats(cnt):
    """Shares from the FZ_REST counts (`rest_counts`): pair-sweeps left
    out (at rest or in a 2-cycle) and at rest alone, overall and by sweep
    index, over the pair-sweeps after sweep 0 of the loop that updates
    every pair."""
    live, gone, cyc = cnt[1:128], cnt[129:256], cnt[390:517]
    hist = cnt[256:384]
    chunks, chunks_gone, iters, rows, pairs = cnt[384:389]
    swept = sum(live) + sum(gone)
    last = max((i for i, h in enumerate(hist) if h), default=0)

    def by_sweep(x):
        return {i + 1: round(g / (v + r), 6)
                for i, (v, r, g) in enumerate(zip(live, gone, x)) if v + r}

    nk = max(1, sum(hist))
    mean_k = sum(k * h for k, h in enumerate(hist)) / nk

    def pct(q):
        acc = 0
        for k, h in enumerate(hist):
            acc += h
            if acc >= q * nk:
                return k
        return last

    at_rest = sum(gone) - sum(cyc)
    return {
        "pair_sweeps_after_sweep0": swept,
        # What the kernel computes: sweep 0 for every pair (the sentinel
        # slot included), then each sweep's live list.
        "pair_sweeps_run": pairs + sum(live),
        "pair_sweeps_left_out": sum(gone),
        "left_out_share": sum(gone) / swept if swept else 0.0,
        "pair_sweeps_at_rest": at_rest,
        "rest_share": at_rest / swept if swept else 0.0,
        "pair_sweeps_in_2cycles": sum(cyc),
        "cycle_share": sum(cyc) / swept if swept else 0.0,
        "rest_share_by_sweep": by_sweep([g - c for g, c in zip(gone, cyc)]),
        "cycle_share_by_sweep": by_sweep(cyc),
        "chunk_sweeps": chunks, "chunk_sweeps_all_left": chunks_gone,
        "all_left_chunk_share": chunks_gone / chunks if chunks else 0.0,
        "list_iterations": iters,
        "list_iterations_per_chunk": iters / chunks if chunks else 0.0,
        "object_groups": rows, "pairs": pairs,
        "k_mean": mean_k, "k_p10": pct(0.1), "k_p50": pct(0.5),
        "k_p90": pct(0.9), "k_max": last,
        "k_hist": {k: h for k, h in enumerate(hist) if h}}


def report(build, rest_lib, run):
    """(rest statistics, SASS list iteration, issue floor ms) of one
    `run()` (which launches the FZ_REST build `rest_lib`'s
    fz_scale_sweeps at F = 5 on full masks and synchronizes): the counts
    (`rest_stats`), the package library's list iteration (`sass_loop`)
    and the issue floor of sweep 0 (about pairs / 32 iterations) and the
    list iterations run, at the card's maximum SM clock; beside it, the
    floor of the loop that updates every pair of its (object, group)
    until it stops.  Raises when the SASS loop or the clock cannot be
    read."""
    import torch

    st = rest_stats(rest_counts(rest_lib, run))
    sass = sass_loop(build, build.library_path())
    clock = max_sm_clock()
    if "instructions" not in sass or clock is None:
        raise RuntimeError(f"no issue floor: SASS {sass}, max SM clock "
                           f"{clock}")
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    n, it0 = sass["instructions"], st["pairs"] / 32
    floor = issue_floor(it0 + st["list_iterations"], n, sms, clock)
    sass.update(max_sm_clock_mhz=clock, sms=sms, issue_floor_ms=floor,
                issue_floor_every_pair_ms=issue_floor(
                    it0 + st["pair_sweeps_after_sweep0"] / 32, n, sms,
                    clock))
    return st, sass, floor


def pair_waits(sweeps):
    """The first design's 2-row blocks on a (B, ng) sweep table: the
    share of blocks whose rows ran different counts, and the share of
    the blocks' row-sweeps (2 max(k0, k1) a block) a frozen row sat out."""
    sw = sweeps[: sweeps.shape[0] // 2 * 2].long()
    k0, k1 = sw[0::2], sw[1::2]
    hi = k0.maximum(k1)
    return {"blocks_with_a_waiting_row": float((k0 != k1).float().mean()),
            "row_sweeps_waited": float((k0 - k1).abs().sum()
                                       / (2 * hi).sum().clamp_min(1))}


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_BRA = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)")


def _cuobjdump(build):
    found = shutil.which("cuobjdump")
    if found:
        return found
    nvcc = build.nvcc_path()
    cand = Path(nvcc).parent / "cuobjdump" if nvcc else None
    return str(cand) if cand and cand.exists() else None


def sass_loop(build, lib_path, inst="ILb1ELb1ELb1ELi5EE", nrcp=6):
    """Instructions of the innermost loop of scale_sweeps_kernel<inst> in
    `cuobjdump -sass` of `lib_path` that holds `nrcp` or more MUFU.RCP
    and a 16-bit shared load (the slot of a list entry): the list
    iteration of sweeps 1 and on, every instruction between the loop's
    head and its backward branch, the rarely taken ones (a pair leaving
    the list) included.  The loop must hold exactly `nrcp` MUFU.RCP (F + 1
    at F = 5: a divide a filter and the scale's): more means the rule
    caught an enclosing loop.  Returns {"instructions", "mufu_rcp",
    "mufu_lg2", "function"} or {"error": ...}."""
    tool = _cuobjdump(build)
    if tool is None:
        return {"error": "no cuobjdump"}
    run = subprocess.run([tool, "-sass", str(lib_path)],
                         capture_output=True, text=True)
    if run.returncode != 0:
        return {"error": run.stderr[-500:]}
    return parse_sass_loop(run.stdout, inst, nrcp)


def sass_loops(text, kernel, inst):
    """Every loop (a backward branch and its target) of the function
    whose mangled name holds `kernel` and `inst` in cuobjdump's text, as
    its instructions [(address, text, branch target or None)] from head to
    backward branch, and the function's name; ([], None) when no such
    function."""
    funcs = re.split(r"\n\s*Function : ", text)
    body = name = None
    for part in funcs[1:]:
        head = part.split("\n", 1)[0].strip()
        if kernel in head and inst in head:
            body, name = part, head
            break
    if body is None:
        return [], None
    insns, labels, pending = [], {}, []
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            labels.update((k, addr) for k in pending)
            pending = []
            insns.append((addr, m.group(2).strip()))

    def target(txt):
        m = _BRA.search(txt)
        if not m:
            return None
        tgt = m.group(1)
        return int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt)

    loops = []
    for addr, txt in insns:
        tgt = target(txt)
        if tgt is not None and tgt < addr:
            loops.append([(a, t, target(t)) for a, t in insns
                          if tgt <= a <= addr])
    return loops, name


def parse_sass_loop(text, inst, nrcp):
    """`sass_loop` on cuobjdump's text."""
    loops, name = sass_loops(text, "scale_sweeps_kernel", inst)
    if name is None:
        return {"error": f"no scale_sweeps_kernel {inst} in the SASS"}
    found = []
    for lp in loops:
        body_ = [t for _, t, _ in lp]
        rcp = sum("MUFU.RCP" in t for t in body_)
        lds16 = any(re.search(r"\bLDS\.U16\b", t) for t in body_)
        if rcp >= nrcp and lds16:
            found.append((len(body_), rcp,
                          sum("MUFU.LG2" in t for t in body_)))
    if not found:
        return {"error": "no list loop found", "function": name}
    n, rcp, lg2 = min(found)
    if rcp != nrcp:
        return {"error": f"the shortest loop holds {rcp} MUFU.RCP, not "
                         f"{nrcp}", "function": name}
    return {"instructions": n, "mufu_rcp": rcp, "mufu_lg2": lg2,
            "function": name}


def issue_floor(iterations, instructions, sms, clock_mhz):
    """Milliseconds the card's schedulers (4 an SM, one warp instruction
    a cycle each) need to issue `iterations` warp iterations of
    `instructions` each at `clock_mhz`."""
    return 1e3 * iterations * instructions / (sms * 4 * clock_mhz * 1e6)


def max_sm_clock():
    """The card's maximum SM clock in MHz (nvidia-smi), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.CalledProcessError, IndexError, ValueError):
        return None
