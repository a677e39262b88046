"""Batch-granular progress reporting (port of `frankenz_tpu.utils.progress`).

The reference writes per-object ``\\r`` progress to stderr inside its hot
loops (e.g. bruteforce.py:120-125); here progress is reported once per
*batch* from the host side, in the same stderr style.
"""

from __future__ import annotations

import sys
import time

__all__ = ["progress_iter", "train_note"]


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


def train_note(verbose, label, nsteps, t0):
    """One-line summary of a training run that executes as one call (the
    SOM kernel, or a step loop): '<label>: <n> steps in <s>s (<rate>/s)'
    on stderr, in place of per-step progress."""
    if verbose:
        dt = max(time.time() - t0, 1e-9)
        sys.stderr.write("\r{}: {} steps in {:.2f}s ({:.0f}/s)\n".format(
            label, nsteps, dt, nsteps / dt))
        sys.stderr.flush()
