"""Runtime utilities: checkpointing, metrics, progress, tracing, and state
conversion from the JAX package."""

from .checkpoint import load_state_dict, restore, save, state_dict  # noqa: F401
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
from .tracing import annotate, device_memory, trace  # noqa: F401
