"""What every route's count shares (`counts/<route>.py`): the bytes of a
call and its stack's operations."""

import numpy as np


def io_bytes(rows, bands, models, ngrid):
    """Each input read once (the catalog's data, errors and mask, the
    models, their errors and mask, G dense, float32) and each output
    written once (the PDFs, lmap, levid)."""
    return 4.0 * (3 * rows * bands + 3 * models * bands + models * ngrid
                  + rows * ngrid + 2 * rows)


def stack_ops(rows, ngrid, ref):
    """A kept pair: its weight (2), and a multiply-add (2) for each
    nonzero entry of its kernel row (the reference's sample means); a
    row: the normalization, a sum and a divide a grid point."""
    per_row = np.mean(2.0 * np.asarray(ref["kept_nnz"], np.float64)
                      + 2.0 * np.asarray(ref["kept"], np.float64))
    return rows * (per_row + 2.0 * ngrid)
