"""
Catalog input across processes (port of `frankenz_tpu.parallel.io`).

Each process loads only its contiguous object block
(`process_shard_bounds`) and places it on its own devices
(`catalog_from_process_shards`); the fit path is data parallel over
objects, so the only traffic between processes is the final reduction
(`mesh.stacked_nz`).
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import OBJ_AXIS, Sharded, _process_topology, shard_objects

__all__ = ["process_shard_bounds", "catalog_from_process_shards",
           "catalog_batches"]


def _tree_map(fn, tree):
    """`fn` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree):
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return tree


def process_shard_bounds(nobj, process_index=None, process_count=None):
    """[start, stop) object range this process should load: contiguous
    blocks over the processes of the torch.distributed group, the last
    taking the remainder."""
    pi, pc = _process_topology()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    per = nobj // pc
    start = pi * per
    stop = nobj if pi == pc - 1 else start + per
    return start, stop


def catalog_from_process_shards(mesh, local_arrays, nobj,
                                process_count=None):
    """Global (nobj, ...) object-sharded arrays from this process's block.

    `local_arrays` is a tree (dicts, lists, tuples) of (Nlocal, ...) host
    arrays holding this process's contiguous block (`process_shard_bounds`);
    the block is split over the process's own devices.  Returns the
    matching tree of `Sharded`, not fully addressable when the group has
    more than one process.  In one process this is `shard_objects`;
    passing `process_count` (the test seam) takes the assembly branch a
    multi-process run takes.
    """
    pc = mesh.process_count if process_count is None else process_count

    def place(x):
        x = np.asarray(x)
        if pc == 1 and process_count is None:
            return shard_objects(mesh, x)
        if x.shape[0] * pc != nobj:
            raise ValueError(f"catalog_from_process_shards: the local block "
                             f"has {x.shape[0]} rows; {pc} equal blocks of "
                             f"{nobj} objects need {nobj // pc}")
        local = shard_objects(mesh, x)
        return Sharded(mesh, local.shards, OBJ_AXIS,
                       (nobj,) + x.shape[1:])

    return _tree_map(place, local_arrays)


def _rows(x, start, n):
    if not isinstance(x, Sharded):
        return x[start:start + n]
    parts = []
    home = x.shards[0].device
    for b, block in enumerate(x.blocks()):
        per = block.shape[0]
        lo, hi = max(start, b * per), min(start + n, (b + 1) * per)
        if lo < hi:
            parts.append(block[lo - b * per:hi - b * per].to(home))
    return torch.cat(parts)


def catalog_batches(arrays, batch_size):
    """Yield ``(start, n, batch)`` over aligned object batches of a tree
    of (Nobj, ...) arrays, tensors or fully addressable `Sharded` (whose
    rows come back as one tensor on the first shard's device); the last
    batch holds the remainder."""
    nobj = _first_leaf(arrays).shape[0]
    for start in range(0, nobj, batch_size):
        n = min(batch_size, nobj - start)
        yield start, n, _tree_map(lambda x: _rows(x, start, n), arrays)
