"""Device kernels a call, the port's and torch's, from the profiler's
kernel events, summed over the cards."""


def read(ctx):
    return ctx.per_call("kernel_n")
