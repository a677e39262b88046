"""The allocator's peak over the window (`torch.cuda.max_memory_allocated`
after a reset at its start), GiB, on the fullest card."""


def read(ctx):
    if ctx.peak_window_bytes is None:
        return None
    return ctx.peak_window_bytes / 2.0 ** 30
