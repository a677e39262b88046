"""Hand-written CUDA kernels (sources in ``csrc/``), their ctypes
wrappers, plain PyTorch versions and launch counters."""

from .fullmask import (  # noqa: F401
    chi2_brackets,
    chi2_brackets_plain,
    chi2_stack,
    chi2_stack_plain,
    launch_counts,
    reset_launch_counts,
)
