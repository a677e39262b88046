"""Hand-written CUDA kernels (sources in ``csrc/``), their ctypes
wrappers, plain PyTorch versions and launch counters.

``fullmask``: the full-mask chi^2 pair (`chi2_brackets`, `chi2_stack`);
``general``: the lnl kernels of every other configuration (`lnl_reduce`,
`lnl_reduce_split`, `lnl_stack`, `lnl_topk`, `lnl_cut_stack`,
`lnl_onepass`), in fixed and free scale, and the free-scale sweep counts
(`scale_sweeps`).
`reset_launch_counts` and `launch_counts` here cover both modules, so a
phase can show which kernels one call launched.
"""

from . import fullmask, general  # noqa: F401
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
    lnl_stack,
    lnl_stack_plain,
    lnl_tile_plain,
    lnl_topk,
    lnl_topk_plain,
    scale_sweeps,
    scale_sweeps_plain,
)


def reset_launch_counts():
    """Set every kernel wrapper's launch count (both modules) to 0."""
    fullmask.reset_launch_counts()
    general.reset_launch_counts()


def launch_counts():
    """{wrapper name: launches since the last reset}, every kernel."""
    return {**fullmask.launch_counts(), **general.launch_counts()}
