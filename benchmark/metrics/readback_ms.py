"""Device milliseconds of device-to-host copies (the PDF, lmap and levid
readback) a call, from the profiler's `Memcpy DtoH` events, summed over
the cards."""


def read(ctx):
    s = ctx.per_call("dtoh_s")
    return None if s is None else 1e3 * s
