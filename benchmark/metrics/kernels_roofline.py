"""The least time a call's work needs at the card's peaks (the larger of
its operations over 67 TFLOP/s and its bytes over 3.35 TB/s, counted by
`counts/`), over the kernel time of the call summed over the cards, %."""


def read(ctx):
    return ctx.roofline()
