"""Build the port's CUDA kernels and load them with ctypes.

`nvcc` compiles every ``frankenz_tpu_torch/csrc/*.cu`` into one shared
library with a plain C interface,
``<checkout>/build/frankenz_tpu_torch/libfz_kernels.so``, at first use
(the sources in parallel; no PyTorch headers are involved).  The library is
rebuilt when any source is newer than it.  Nothing here runs at import
time: the CPU test suite imports every module on machines without
`nvcc`.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["nvcc_path", "library_path", "build", "load", "ptxas_report",
           "parse_ptxas"]

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG.parent / "build" / "frankenz_tpu_torch"
_LIB_NAME = "libfz_kernels.so"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC")

_lib = None


def nvcc_path():
    """Path of `nvcc` (PATH first, then /usr/local/cuda), or None."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def library_path():
    return _BUILD_DIR / _LIB_NAME


def _sources():
    return sorted(_SRC_DIR.glob("*.cu"))


def _stale(lib):
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(p.stat().st_mtime > built
               for p in _sources() + sorted(_SRC_DIR.glob("*.cuh")))


def build(force=False):
    """Compile the kernels if needed; returns the seconds spent (0.0
    when the library was already current)."""
    lib = library_path()
    if not force and not _stale(lib):
        return 0.0
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # One nvcc per source, all started together (lnl_general.cu and
    # lnl_freescale.cu, with their many template instantiations, take
    # tens of seconds each; chi2_fullmask.cu, chi2_screened.cu,
    # lnl_table.cu, scale_sweeps.cu, som_train.cu, gng_train.cu,
    # pop_chain.cu and cluster_probe.cu seconds),
    # then one link.  The library is written to a temporary name and
    # renamed: a concurrent loader never sees a half-written one.
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in _sources()]
        cmds = [[nvcc, *_NVCC_FLAGS, "-c", "-o", o, str(p)]
                for p, o in zip(_sources(), objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        so = os.path.join(tmp, _LIB_NAME)
        cmds.append([nvcc, "-shared", "-o", so, *objs])
        if all(p.returncode == 0 for p in procs):
            link = subprocess.run(cmds[-1], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            procs.append(link)
            outs.append(link.stdout)
        for cmd, p, out in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
        os.replace(so, lib)
    return time.perf_counter() - t0


def ptxas_report(source):
    """What `nvcc -Xptxas -v` reports for every kernel of `source` (a
    file name in ``csrc/`` or a path; ``csrc/`` is on the include path)
    compiled alone with the library's flags:
    {mangled name: {"registers", "spill_stores", "spill_loads",
    "stack", "static_smem"}} (bytes; dynamic shared memory is the
    launch's, not ptxas's)."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: no ptxas report")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        run = subprocess.run(
            [nvcc, *_NVCC_FLAGS, "-I", str(_SRC_DIR), "-Xptxas", "-v", "-c",
             "-o", os.path.join(tmp, "report.o"), str(_SRC_DIR / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{run.stdout}")
    return parse_ptxas(run.stdout)


def parse_ptxas(text):
    """{mangled name: {"registers", "spill_stores", "spill_loads", "stack",
    "static_smem"}} from the output of an nvcc run with -Xptxas -v."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m.group(1)) if m else 0
    return out


def _bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # csrc/chi2_fullmask.cu: shared-memory bytes (F; pass B also Ngrid),
    # chunks, pass A's CTAs an SM, and the launches (pointers, sizes with
    # the model rows' stride after M; pass A its splits and models a
    # split, pass B G's row stride and the tiles' bands, NULL: every
    # column).
    for name, nargs in (("fz_chi2_brackets_smem", 1),
                        ("fz_chi2_stack_smem", 2),
                        ("fz_chi2_brackets_chunk", 0),
                        ("fz_chi2_stack_chunk", 2),
                        ("fz_chi2_brackets_occupancy", 1)):
        getattr(lib, name).argtypes = [I] * nargs
        getattr(lib, name).restype = I
    lib.fz_chi2_brackets.argtypes = [P] * 6 + [I] * 6 + [F, I, P]
    lib.fz_chi2_brackets.restype = I
    lib.fz_chi2_stack.argtypes = ([P] * 5 + [I] + [P] * 4 + [I] * 5
                                  + [F, I, F, I, P])
    lib.fz_chi2_stack.restype = I
    lib.fz_fast_probe.argtypes = [P, P, P, P, I, I, P]
    lib.fz_fast_probe.restype = I
    # csrc/chi2_screened.cu: the object block, shared-memory sizes, the
    # screened trio (pointers, sizes with the model rows' stride after M,
    # constants, flags, stream) and the expf probe.
    lib.fz_screen_tb.argtypes = []
    lib.fz_screen_tb.restype = I
    for name, nargs in (("fz_screen_bound_seed_smem", 1),
                        ("fz_chi2_brackets_screened_smem", 1),
                        ("fz_chi2_stack_screened_smem", 2)):
        getattr(lib, name).argtypes = [I] * nargs
        getattr(lib, name).restype = I
    lib.fz_screen_bound_seed.argtypes = [P] * 11 + [I] * 9 + [F] * 5 + [I,
                                                                        P]
    lib.fz_screen_bound_seed.restype = I
    lib.fz_chi2_brackets_screened.argtypes = [P] * 8 + [I] * 6 + [F, I, P]
    lib.fz_chi2_brackets_screened.restype = I
    lib.fz_chi2_stack_screened.argtypes = ([P] * 14 + [I] * 7 + [F, I, F]
                                           + [I] * 2 + [P])
    lib.fz_chi2_stack_screened.restype = I
    lib.fz_expf_probe.argtypes = [P, P, I, P]
    lib.fz_expf_probe.restype = I
    for name, nargs in (("fz_lnl_reduce_smem", 2),
                        ("fz_lnl_reduce_topk_smem", 3),
                        ("fz_lnl_stack_smem", 1), ("fz_scale_sweeps_smem", 4),
                        ("fz_scale_sweeps_occupancy", 4),
                        ("fz_scale_sweeps_warps", 4),
                        ("fz_lnl_reduce_store_smem", 1),
                        ("fz_lnl_band_smem", 4), ("fz_lnl_band_blocks", 4)):
        getattr(lib, name).argtypes = [I] * nargs
        getattr(lib, name).restype = I
    # Pointers (7 inputs, then outputs / extra inputs), sizes, flags,
    # nd_full, the sweep table with its width and group width, (threads,)
    # stream: see the FZ_ENTRY_POINTS macro of csrc/lnl_common.cuh.  The
    # fixed-scale entry points (csrc/lnl_general.cu) and the free-scale
    # ones (csrc/lnl_freescale.cu, suffix _fs) share each signature.
    tail = [F, P, I, I]
    general = {
        "fz_lnl_reduce": [P] * 9 + [I] * 6 + tail + [P],
        "fz_lnl_reduce_split": [P] * 11 + [I] * 6 + tail + [P],
        # The cdf mode's reduce and top-T: lmap, levid, vals, cnts.
        "fz_lnl_reduce_topk": [P] * 11 + [I] * 7 + tail + [P],
        "fz_lnl_stack": [P] * 11 + [I] * 4 + [F] + [I] * 3 + tail + [I, P],
        # The band kernels (csrc/lnl_band.cuh): G, perm (, inv), bands,
        # the rows and outputs, sizes with G's stride and the widest band.
        "fz_lnl_cut_stack": [P] * 16 + [I] * 9 + tail + [P],
        "fz_lnl_onepass": [P] * 13 + [I] * 9 + tail + [P],
        # The table route's producer: the lnl table and its stride after
        # lmap and levid, no sweep table.
        "fz_lnl_reduce_store": [P] * 10 + [I] * 7 + [F, P],
    }
    for name, argtypes in general.items():
        for fn in (getattr(lib, name), getattr(lib, name + "_fs")):
            fn.argtypes = argtypes
            fn.restype = I
    # Pointers (the lnl table NULL for the sweep table alone), ldm, sizes,
    # flags, ltol, max_iter, nd_full, stream.
    lib.fz_scale_sweeps.argtypes = [P] * 9 + [I] * 8 + [F, I, F, P]
    lib.fz_scale_sweeps.restype = I
    # csrc/lnl_table.cu: the lnl table's readers.
    lib.fz_lnl_reduce_read.argtypes = [P, I, P, P, I, I, P]
    lib.fz_lnl_reduce_read.restype = I
    lib.fz_lnl_stack_read.argtypes = [P, I] + [P] * 4 + [I] * 3 + [F, I, P]
    lib.fz_lnl_stack_read.restype = I
    # The band-order reader: G with its stride, the bands, the widest band.
    lib.fz_lnl_stack_band.argtypes = ([P, I, P, I, P, I] + [P] * 3
                                      + [I] * 3 + [F, P])
    lib.fz_lnl_stack_band.restype = I
    lib.fz_lnl_stack_read_smem.argtypes = [I]
    lib.fz_lnl_stack_read_smem.restype = I
    # csrc/som_train.cu: pointers, sizes, off, nsteps_total, nside,
    # wt_thresh, flags, the two schedules, threads, resident, stream.
    lib.fz_som_train_smem.argtypes = [I] * 4
    lib.fz_som_train_smem.restype = I
    lib.fz_som_train.argtypes = ([P] * 7 + [I] * 4 + [F, I, F, F, I, I]
                                 + [I, F, F, F, F] * 2 + [I, I, P])
    lib.fz_som_train.restype = I
    # Its cluster route: shared-memory bytes (N, F, P, K), the card's
    # schedulability query (N, F, P, K, threads) and the launch (the block
    # route's arguments with the cluster size in place of `resident`).
    lib.fz_som_train_cluster_smem.argtypes = [I] * 4
    lib.fz_som_train_cluster_max_active.argtypes = [I] * 5
    lib.fz_som_train_cluster.argtypes = lib.fz_som_train.argtypes
    # csrc/gng_train.cu: 11 pointers, sizes, nbatch, max_age, the four
    # constants, dim_prior, threads, resident, stream.
    lib.fz_gng_train_smem.argtypes = [I] * 3
    lib.fz_gng_train_smem.restype = I
    lib.fz_gng_train.argtypes = [P] * 11 + [I] * 5 + [F] * 4 + [I] * 3 + [P]
    lib.fz_gng_train.restype = I
    # csrc/pop_chain.cu: 11 pointers (the dcol scratch NULL when resident),
    # nchains, T, W, nbins, nobs, thin, mh, threads, resident, stream.
    lib.fz_pop_chain_smem.argtypes = [I] * 4
    lib.fz_pop_chain_smem.restype = I
    lib.fz_pop_chain.argtypes = [P] * 11 + [I] * 9 + [P]
    lib.fz_pop_chain.restype = I
    # The cluster routes of the two chain kernels: shared-memory bytes,
    # the card's schedulability query (clusters held at once, or minus a
    # CUDA error) and the launch (the block route's arguments with the
    # cluster size in place of `resident`; pop_chain's has no dcol
    # scratch).
    lib.fz_gng_train_cluster_smem.argtypes = [I] * 3
    lib.fz_gng_train_cluster_max_active.argtypes = [I] * 4
    lib.fz_gng_train_cluster.argtypes = ([P] * 11 + [I] * 5 + [F] * 4
                                         + [I] * 3 + [P])
    lib.fz_pop_chain_cluster_smem.argtypes = [I] * 4
    lib.fz_pop_chain_cluster_max_active.argtypes = [I] * 5
    lib.fz_pop_chain_cluster.argtypes = [P] * 10 + [I] * 9 + [P]
    # csrc/cluster_probe.cu: the query, and K, mode, iterations, the
    # cycles and sink outputs, stream.
    lib.fz_cluster_probe_max_active.argtypes = [I]
    lib.fz_cluster_probe.argtypes = [I, I, I, P, P, P]
    for name in ("fz_som_train_cluster_smem",
                 "fz_som_train_cluster_max_active", "fz_som_train_cluster",
                 "fz_gng_train_cluster_smem",
                 "fz_gng_train_cluster_max_active", "fz_gng_train_cluster",
                 "fz_pop_chain_cluster_smem",
                 "fz_pop_chain_cluster_max_active", "fz_pop_chain_cluster",
                 "fz_cluster_probe_max_active", "fz_cluster_probe"):
        getattr(lib, name).restype = I
    return lib


def load():
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        build()
        _lib = _bind(ctypes.CDLL(str(library_path())))
    return _lib
