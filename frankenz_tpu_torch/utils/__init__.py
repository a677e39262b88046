"""Runtime utilities: metrics, progress, and state conversion."""

from .convert import (  # noqa: F401
    bruteforce_from_arrays,
    from_jax_bruteforce,
    knn_from_jax,
    network_from_jax,
    pdfdict_from,
    sampler_from_jax,
)
from .metrics import Metrics, metrics, timed  # noqa: F401
from .progress import progress_iter, train_note  # noqa: F401
