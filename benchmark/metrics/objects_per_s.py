"""Objects whose PDF, lmap and levid reached the host, over the window
(first call start to last call end), over all the cards the call uses."""


def read(ctx):
    return ctx.rate
