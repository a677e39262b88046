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
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["nvcc_path", "library_path", "build", "load"]

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
    # tens of seconds each), then one link.  The library is written to a
    # temporary name and renamed: a concurrent loader never sees a
    # half-written one.
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


def _bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fz_chi2_brackets_smem.argtypes = [I]
    lib.fz_chi2_brackets_smem.restype = I
    lib.fz_chi2_stack_smem.argtypes = [I]
    lib.fz_chi2_stack_smem.restype = I
    lib.fz_chi2_brackets.argtypes = [P, P, P, P, P, P, I, I, I, F, I, P]
    lib.fz_chi2_brackets.restype = I
    lib.fz_chi2_stack.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, F, I,
                                  F, I, I, P]
    lib.fz_chi2_stack.restype = I
    for name, nargs in (("fz_lnl_reduce_smem", 2), ("fz_lnl_topk_smem", 3),
                        ("fz_lnl_stack_smem", 1), ("fz_scale_sweeps_smem", 2)):
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
        "fz_lnl_topk": [P] * 9 + [I] * 7 + tail + [P],
        "fz_lnl_stack": [P] * 11 + [I] * 4 + [F] + [I] * 3 + tail + [I, P],
        "fz_lnl_cut_stack": [P] * 13 + [I] * 7 + tail + [I, P],
        "fz_lnl_onepass": [P] * 11 + [I] * 7 + tail + [I, P],
    }
    for name, argtypes in general.items():
        for fn in (getattr(lib, name), getattr(lib, name + "_fs")):
            fn.argtypes = argtypes
            fn.restype = I
    lib.fz_scale_sweeps.argtypes = [P] * 7 + [I] * 6 + [F, I, F, P]
    lib.fz_scale_sweeps.restype = I
    return lib


def load():
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        build()
        _lib = _bind(ctypes.CDLL(str(library_path())))
    return _lib
