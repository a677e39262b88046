"""What the metric readers share: a run's context and per-call sums of
the trace.  A reader returns None where its run has nothing for it to
read (an untraced run, a card with no peaks); it never returns 0 in place
of a reading.  Which cells report a metric is `BENCHMARK.json`'s to say
(its ``workloads``), so one reader serves every name that shares its
base name (``kernel_ms``, ``kernel_ms.free``)."""

from __future__ import annotations


class Context:
    """What one run measured, for the readers.

    `rate`: objects/s over the window; `setup_s`; `trace`: `trace.summarize`'s
    dict (traced runs); `device_ids`: the cards used; `least_s`: the
    least time a traced call's work needs at the card's peaks;
    `peak_window_bytes`: the allocator's peak over the window on the
    fullest card."""

    def __init__(self, rate, setup_s, trace=None, device_ids=(0,),
                 least_s=None, peak_window_bytes=None):
        self.rate = rate
        self.setup_s = setup_s
        self.trace = trace
        self.device_ids = tuple(device_ids)
        self.least_s = least_s
        self.peak_window_bytes = peak_window_bytes

    def devices(self):
        """The trace's figures of every card used (zeros where a card
        ran nothing)."""
        devs = self.trace["devices"]
        zero = dict(busy_s=0.0, kernel_s=0.0, kernel_n=0, dtoh_s=0.0,
                    copy_s=0.0, memset_s=0.0)
        return [devs.get(d, devs.get(str(d), zero)) for d in self.device_ids]

    def per_call(self, key):
        """The trace's `key` summed over the cards, a call; None
        untraced."""
        if self.trace is None or \
                not self.trace["calls"] or not self.trace["devices"]:
            return None
        return sum(d[key] for d in self.devices()) / self.trace["calls"]

    def idle_shares(self):
        if self.trace is None or not self.trace["devices"]:
            return None
        w = self.trace["window_s"]
        if w <= 0:
            return None
        return [100.0 * (1.0 - d["busy_s"] / w) for d in self.devices()]

    def roofline(self):
        """The least time of a call's work over its kernel time, %."""
        kernel_s = self.per_call("kernel_s")
        if kernel_s is None or not kernel_s or self.least_s is None:
            return None
        return 100.0 * self.least_s / kernel_s
