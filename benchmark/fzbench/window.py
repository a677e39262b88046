"""The measured window: the calls, the rate, and the sample of answers
the output check reads."""

from __future__ import annotations

import time

import numpy as np

from . import traffic


class Sample:
    """The `size` answers of the window with the smallest keys
    (`traffic.sample_keys`): a uniform sample of every row every call
    returned, kept as the calls come."""

    def __init__(self, seed, size):
        self.seed, self.size = int(seed), int(size)
        self.keys = np.empty(0, np.float32)
        self.where = np.empty((0, 2), np.int64)  # (chunk, row)
        self.pdf = self.lmap = self.levid = None

    def add(self, call, chunk, out):
        pdf, (lmap, levid) = out
        keys = traffic.sample_keys(self.seed, call, len(lmap))
        take = (np.argpartition(keys, self.size - 1)[:self.size]
                if len(keys) > self.size else np.arange(len(keys)))
        where = np.stack([np.full(len(take), chunk), take], axis=1)
        parts = [(self.keys, keys[take]), (self.where, where)]
        if self.pdf is None:
            self.pdf, self.lmap, self.levid = pdf[:0], lmap[:0], levid[:0]
        parts += [(self.pdf, pdf[take]), (self.lmap, lmap[take]),
                  (self.levid, levid[take])]
        merged = [np.concatenate(p) for p in parts]
        best = np.argsort(merged[0], kind="stable")[:self.size]
        (self.keys, self.where, self.pdf, self.lmap,
         self.levid) = (m[best] for m in merged)

    def rows_of(self, chunk):
        """Positions in the sample, and rows of chunk `chunk`."""
        pos = np.nonzero(self.where[:, 0] == chunk)[0]
        return pos, self.where[pos, 1]


def window_rate(objects, starts, ends):
    """Objects returned over the window's time: from the first call's
    start to the last call's end (all the work, all the time)."""
    if not len(starts):
        return None
    span = max(ends) - min(starts)
    return float(sum(objects)) / span if span > 0 else None


class Window:
    """Calls run back to back until `seconds` have passed since the
    first began; a call that raises counts as failed, with no objects."""

    def __init__(self, seconds):
        self.seconds = float(seconds)
        self.starts, self.ends, self.objects = [], [], []
        self.failed = 0
        self.errors = []

    def run(self, call, on_result=None, clock=time.perf_counter):
        t_first = None
        k = 0
        while True:
            t0 = clock()
            t_first = t0 if t_first is None else t_first
            try:
                out, n = call(k)
            except Exception as exc:  # noqa: BLE001 -- a failed answer
                out, n = None, 0
                self.failed += 1
                self.errors.append(repr(exc))
            t1 = clock()
            self.starts.append(t0)
            self.ends.append(t1)
            self.objects.append(n)
            if out is not None and on_result is not None:
                on_result(k, out)
            del out
            k += 1
            if clock() - t_first >= self.seconds:
                return

    @property
    def attempted(self):
        return len(self.starts)

    @property
    def rate(self):
        return window_rate(self.objects, self.starts, self.ends)

    @property
    def span_s(self):
        return max(self.ends) - min(self.starts) if self.starts else 0.0
