"""The share of the traced window in which no kernel, copy or memset ran
on the card (the union of their intervals), mean over the cards, %."""


def read(ctx):
    shares = ctx.idle_shares()
    return None if shares is None else sum(shares) / len(shares)
