"""Runtime utilities: metrics, progress, and state conversion."""

from .convert import (  # noqa: F401
    bruteforce_from_arrays,
    from_jax_bruteforce,
    pdfdict_from,
)
from .metrics import Metrics, metrics, timed  # noqa: F401
from .progress import progress_iter  # noqa: F401
