"""The chain kernels' cluster route rule, shared by `som`, `gng` and `pop`.

A chain kernel's cluster route runs one chain on a thread-block cluster of
K CTAs, K in CLUSTER_SIZES.  `som` and `gng` give a CTA one thread a node
slot (`cluster_threads`) and take the largest K the card schedules
(`choose_cluster`); `pop` picks K by its own rule over the same query.
`max_active` asks the card how many clusters of one shape it holds at
once, through the two entry points every cluster route exports:
``fz_<entry>_smem`` (a CTA's dynamic shared bytes) and
``fz_<entry>_max_active`` (`cudaOccupancyMaxActiveClusters`, minus the CUDA
error on failure).
"""

from __future__ import annotations

import functools

import torch

from . import build as _build
from .fullmask import _SMEM_MAX

__all__ = ["CLUSTER_SIZES", "CLUSTER_ORDER", "cluster_threads",
           "choose_cluster", "max_active"]

# Cluster sizes of the cluster routes (16 is above the portable 8: not
# every card schedules it), in the order `choose_cluster` prefers them.
CLUSTER_SIZES = (2, 4, 8, 16)
CLUSTER_ORDER = (16, 8, 4, 2)
_MIN_THREADS, _MAX_THREADS = 128, 512  # the cluster kernels' launch bound


def cluster_threads(N, k):
    """Threads of a cluster CTA: one a node slot, in [128, 512]."""
    slots = -(-int(N) // k)
    return min(_MAX_THREADS, max(_MIN_THREADS, -(-slots // 32) * 32))


def choose_cluster(active):
    """The cluster size for one run: the first of CLUSTER_ORDER with at
    least one cluster held at once in `active` ({K: clusters of this shape
    the card holds, for the sizes whose CTA fits in shared memory}); 1
    (the block route) when none is."""
    return next((k for k in CLUSTER_ORDER if active.get(k, 0) >= 1), 1)


@functools.lru_cache(maxsize=None)
def max_active(entry, device_index, smem_args, query_args):
    """Clusters of one shape the card `device_index` holds at once:
    ``fz_<entry>_max_active(*query_args)``, or 0 when a CTA's
    ``fz_<entry>_smem(*smem_args)`` bytes do not fit in shared memory;
    raises on a CUDA error."""
    lib = _build.load()
    if getattr(lib, f"fz_{entry}_smem")(*smem_args) > _SMEM_MAX:
        return 0
    with torch.cuda.device(device_index):
        n = getattr(lib, f"fz_{entry}_max_active")(*query_args)
    if n < 0:
        raise RuntimeError(f"{entry}: the cluster query {query_args} "
                           f"failed: CUDA error {-n}")
    return n
