"""Batch-granular progress reporting (port of `frankenz_tpu.utils.progress`).

The reference writes per-object ``\\r`` progress to stderr inside its hot
loops (e.g. bruteforce.py:120-125); here progress is reported once per
*batch* from the host side, in the same stderr style.
"""

from __future__ import annotations

import sys
import time

__all__ = ["progress_iter"]


def progress_iter(iterable, total=None, label="", verbose=True, sizes=False):
    """Yield from `iterable`, writing '\\r<label> i/total' to stderr.

    With ``sizes=True`` the iterable yields ``(start, n)`` pairs and
    progress advances by ``n``; otherwise it advances by 1 per item.
    """
    done = 0
    t0 = time.time()
    for item in iterable:
        yield item
        done += item[1] if sizes else 1
        if verbose:
            msg = "\r{} {}/{}".format(label, done, total if total else "?")
            if done and total:
                rate = done / max(time.time() - t0, 1e-9)
                msg += " ({:.0f}/s)".format(rate)
            sys.stderr.write(msg)
            sys.stderr.flush()
    if verbose:
        sys.stderr.write("\n")
        sys.stderr.flush()
