"""Device milliseconds of kernels a call (copies and memsets left out),
summed over the cards."""


def read(ctx):
    s = ctx.per_call("kernel_s")
    return None if s is None else 1e3 * s
