"""Process start to the first timed call: imports, the kernel build
(the first run in a checkout), the inputs, the model set, one warm call."""


def read(ctx):
    return ctx.setup_s
