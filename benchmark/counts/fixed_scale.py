"""Work one call of the fixed-scale route needs, whatever implements it.

Inputs: the call's data mask (its observed bands), the configuration and
the reference's readings on a sample of the window's rows (``kept``: kept
pairs a row, ``kept_nnz``: their nonzero kernel entries).  Nothing the
program reports about its own work enters: not the pairs a screen or a
gate admits, not a table's round trip, not the band order.

Operations (a divide, log or exp counts as one):
* a pair, over each observed band: the variance's sum, the residual, its
  square, the divide and the sum (5); the chi^2 density (5); lmap's max
  and levid's subtract, exp and add (4);
* the stack and the normalization, and the bytes: `fzbench.work`.
"""

import numpy as np

from fzbench.work import io_bytes, stack_ops

BAND_OPS, PAIR_OPS = 5, 9


def count(mask, config, ref):
    """(operations, bytes) of one call over the rows of `mask`."""
    rows, bands = mask.shape
    models, ngrid = int(config["models"]["n"]), int(config["grid"]["n"])
    observed = float(np.asarray(mask, np.float64).sum())
    ops = models * (BAND_OPS * observed + PAIR_OPS * rows)
    ops += stack_ops(rows, ngrid, ref)
    return ops, io_bytes(rows, bands, models, ngrid)
