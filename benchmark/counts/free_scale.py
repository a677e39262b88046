"""Work one call of the free-scale route (model errors kept) needs,
whatever implements it.

Inputs as `fixed_scale.py`'s, and from the reference's sample also
``sweeps`` (the sweeps of the scale's fixed point the reference's own
convergence rule ran for the row: the first and each refinement) and
``observed`` (the row's observed bands).  The kernels' own early exits
(per model group, pairs at rest) do not enter.

Operations a pair, each sweep: over each observed band the scaled model
error's product and square, the variance's sum, its inverse, the three
products and sums of the scale's numerator and denominator, the log of
the variance and its sum, and the residual pass (the scaled model, the
residual, its square, the weight and the sum): 17; the scale's divide,
the Normal log-likelihood (3) and the convergence test (2): 6.  Then the
chi^2 density (5) and lmap / levid (4) once.  The stack, the
normalization and the bytes: `fzbench.work`.
"""

import numpy as np

from fzbench.work import io_bytes, stack_ops

SWEEP_BAND_OPS, SWEEP_PAIR_OPS, PAIR_OPS = 17, 6, 9


def count(mask, config, ref):
    """(operations, bytes) of one call over the rows of `mask`."""
    rows, bands = mask.shape
    models, ngrid = int(config["models"]["n"]), int(config["grid"]["n"])
    sweeps = np.asarray(ref["sweeps"], np.float64)
    observed = np.asarray(ref["observed"], np.float64)
    per_row = np.mean(sweeps * (SWEEP_BAND_OPS * observed + SWEEP_PAIR_OPS))
    ops = models * rows * (per_row + PAIR_OPS)
    ops += stack_ops(rows, ngrid, ref)
    return ops, io_bytes(rows, bands, models, ngrid)
