"""Hand-written CUDA kernels (sources in ``csrc/``), their ctypes
wrappers, plain PyTorch versions and launch counters.

``fullmask``: the full-mask chi^2 pair (`chi2_brackets`, `chi2_stack`);
``screened``: the screened full-mask trio (`screen_bound_seed`, the seed
stage, `chi2_brackets_screened`, `chi2_stack_screened`);
``general``: the lnl kernels of every other configuration (`lnl_reduce`,
`lnl_reduce_split`, `lnl_stack`, `lnl_stack_band`, `lnl_reduce_topk`,
`lnl_topk`, `lnl_cut_stack`, `lnl_onepass`), in fixed and free scale, and
the free-scale sweep counts
(`scale_sweeps`); ``som``: the whole SOM training run (`som_train`);
``gng``: the whole GrowingNeuralGas training run (`gng_train`); ``pop``:
whole flat-prior population MH-in-Gibbs chains (`pop_chain`).  The three
chain kernels run one chain on one block or on a thread-block cluster
(``cluster``: the route rule they share); ``probe`` times a cluster's barrier and DSMEM loads (`cluster_probe`).
`reset_launch_counts` and `launch_counts` here cover every module, so a
phase can show which kernels one call launched.
"""

from . import (  # noqa: F401
    cluster, fullmask, general, gng, pop, probe, screened, som)
from .fullmask import (  # noqa: F401
    chi2_brackets,
    chi2_brackets_plain,
    chi2_stack,
    chi2_stack_plain,
)
from .general import (  # noqa: F401
    lnl_cut_stack,
    lnl_cut_stack_plain,
    lnl_onepass,
    lnl_onepass_plain,
    lnl_reduce,
    lnl_reduce_split,
    lnl_reduce_split_plain,
    lnl_reduce_plain,
    lnl_reduce_topk,
    lnl_reduce_topk_plain,
    lnl_stack,
    lnl_stack_band,
    lnl_stack_band_plain,
    lnl_stack_plain,
    lnl_tile_plain,
    lnl_topk,
    lnl_topk_plain,
    scale_sweeps,
    scale_sweeps_plain,
)
from .gng import gng_train, gng_train_plain  # noqa: F401
from .pop import pop_chain, pop_chain_plain  # noqa: F401
from .screened import (  # noqa: F401
    chi2_brackets_screened,
    chi2_brackets_screened_plain,
    chi2_stack_screened,
    chi2_stack_screened_plain,
    screen_bound_seed,
    screen_bound_seed_plain,
)
from .som import som_train, som_train_plain  # noqa: F401


def reset_launch_counts():
    """Set every kernel wrapper's launch count (every module) to 0."""
    fullmask.reset_launch_counts()
    screened.reset_launch_counts()
    general.reset_launch_counts()
    som.reset_launch_counts()
    gng.reset_launch_counts()
    pop.reset_launch_counts()


def launch_counts():
    """{wrapper name: launches since the last reset}, every kernel."""
    return {**fullmask.launch_counts(), **screened.launch_counts(),
            **general.launch_counts(),
            **som.launch_counts(), **gng.launch_counts(),
            **pop.launch_counts()}
