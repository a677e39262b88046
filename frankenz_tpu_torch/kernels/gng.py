"""Wrapper and plain version of the GNG training kernel (K9).

`gng_train` runs a whole GrowingNeuralGas training run (or one segment
of it) in one launch of ``csrc/gng_train.cu``, the counterpart of the
Pallas kernel `_make_gng_mega_kernel`
(frankenz_tpu/models/networks.py:2017); the design notes are in the
source.

The whole state goes in and comes out, so segments compose (a segment
must start on an `nbatch` block: the prune / insert fires at the local
steps i % nbatch == 0):

* ``pos`` (N, F) float32 node table; ``err`` (N,) float32 accumulated
  errors; ``alive`` (N,) bool;
* ``ids`` (N, 32) int32 neighbour ids per node (-1 empty), ``sref``
  (N, 32) int32 per-slot aging anchors and ``c`` (N,) int32 per-node
  best-node counters: the age of slot k of node i is c[i] - sref[i, k]
  (networks.py:1714-1736);
* ``overflow``: the count of edge insertions dropped so far because a
  node already held 32 edges.

The draws of the T steps arrive as `som_kernel_draws` makes them: ``xc``,
``iv`` (bad bands: xc = 0 and iv = 0) and the raw rows ``xr``, each
(T, F) float32.

Where the Pallas kernel and the JAX scan (`_gng_train_jit`) differ, this
follows the Pallas kernel: a node is the best node's neighbour iff its
own slots hold the best node (a column search), the insert's second
parent is the lowest-index node of largest error among the nodes whose
slots hold the first, and dead nodes score -3e38.  NaN follows the JAX
scan (the Pallas kernel's equality tests find no node at a NaN maximum):
a NaN score counts as -inf, below every dead node, as the scan's compiled
`top_k` ranks the negative NaN its score chain leaves (it orders floats
by their bits); a NaN error ranks above every number in the insert's
picks, as `jnp.argmax` ranks it.  A node
a step leaves alone keeps its value by selection, never by a zero
multiple of the update, so a NaN in a masked band of a draw reaches
only the nodes the step moves.  A selection that finds no candidate
gives the index `NONE` (1e9, the Pallas kernel's own `big`).

On the card the run takes one of two routes of the same source: one
thread block (``gng_train_kernel``, its node table in shared memory when
it fits, the adjacency in device memory), or a thread-block cluster of K
CTAs (``gng_train_cluster_kernel``, K = 2 to 16) that holds every node's
state and adjacency rows in the shared memory of the CTA that owns it.
The two agree bit for bit.  `choose_cluster` picks K from the sizes whose
CTA fits in shared memory and the card's schedulability query; with none
the run takes the block; ``cluster=`` forces a route (1: the block).  A
refused cluster launch raises: there is no retry on the block.

On a CPU tensor the wrapper runs `gng_train_plain`; on a CUDA tensor it
launches the kernel or raises: there is no fallback.
``gng_train.launches`` counts the block route's launches and
``gng_train.cluster_launches`` the cluster route's (`launch_counts` names
them ``gng_train`` and ``gng_train_cluster``).  The plain version makes the
kernel's operations in its order, with every constant a tensor on the
inputs' device, so on the card the two agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build as _build
from .cluster import CLUSTER_ORDER, CLUSTER_SIZES, choose_cluster, \
    cluster_threads, max_active
from .fullmask import _SMEM_MAX, _check

__all__ = ["gng_train", "gng_train_plain", "choose_cluster",
           "cluster_threads", "MAX_NODES", "MAX_FILT", "K", "NONE",
           "CLUSTER_SIZES", "CLUSTER_ORDER", "reset_launch_counts",
           "launch_counts"]

# The kernel's own limits: past shared memory the per-node state stays in
# device memory, so the node cap is that of the SOM kernel.
MAX_NODES = 32768
MAX_FILT = 120
K = 32
NONE = 1_000_000_000
NEG = -3.0e38
_MIN_THREADS, _MAX_THREADS = 128, 1024


def _active(device_index, N, F, k):
    """Clusters of k CTAs at N nodes x F filters the card holds at once
    (0 when the CTA does not fit in shared memory)."""
    return max_active("gng_train_cluster", device_index, (N, F, k),
                      (N, F, k, cluster_threads(N, k)))


def _constants(learn_best, learn_neighbor, new_err_dec, all_err_dec):
    """The float32 constants, rounded from double as JAX rounds its weakly
    typed Python floats (1 - x is taken in double first)."""
    return tuple(float(np.float32(v)) for v in (
        learn_best, learn_neighbor, 1.0 - new_err_dec, 1.0 - all_err_dec))


def _argbest(v, cand):
    """Index of the best of `v` over the boolean `cand` (NaN above every
    number, then the lowest index), or NONE when `cand` is empty."""
    if not bool(cand.any()):
        return NONE
    nan = torch.isnan(v) & cand
    if bool(nan.any()):
        return int(torch.argmax(nan.to(torch.int32)))
    return int(torch.argmax(torch.where(cand, v, -torch.inf)))


def _upsert(ids, sref, i, j, ci):
    """Create or refresh edge j in node i's slots (age -> 0): the lowest
    slot holding j, else the lowest free slot, else a drop, the rule of
    both JAX routes (frankenz_tpu/models/networks.py:1777-1794 in the
    scan, which the general route of `GrowingNeuralGas` uses too).  `i`
    and `j` are ints or 0-d tensors; returns the drop (0 or 1) as a 0-d
    int32."""
    row = ids[i]
    match = row == j
    has = match.any()
    free = row < 0
    slot = torch.where(has, torch.argmax(match.to(torch.int32)),
                       torch.argmax(free.to(torch.int32)))
    dropped = ~has & ~free.any()
    ids[i, slot] = torch.where(dropped, ids[i, slot],
                               torch.as_tensor(j, dtype=ids.dtype,
                                               device=ids.device))
    sref[i, slot] = torch.where(dropped, sref[i, slot],
                                torch.as_tensor(ci, dtype=sref.dtype,
                                                device=sref.device))
    return dropped.to(torch.int32)


def gng_train_plain(pos, err, alive, ids, sref, c, overflow, xc, iv, xr, *,
                    nbatch, max_age=15, learn_best=0.2, learn_neighbor=0.005,
                    new_err_dec=0.5, all_err_dec=0.005, dim_prior=True):
    """Plain version of `gng_train`: a step loop in torch with the
    kernel's operations in its order (the batch update reads its picks
    back to the host)."""
    dev = pos.device
    f32 = torch.float32
    T, F = xc.shape
    N = pos.shape[0]

    def c32(v):
        return torch.tensor(np.float32(v), dtype=f32, device=dev)

    lb, ln, dec_new, dec_all = (c32(v) for v in _constants(
        learn_best, learn_neighbor, new_err_dec, all_err_dec))
    tiny, half, zero, neg = c32(1e-30), c32(0.5), c32(0.0), c32(NEG)
    pos, err, ids, sref, c = (t.clone() for t in (pos, err, ids, sref, c))
    alive = alive.clone()
    ov = torch.tensor(int(overflow), dtype=torch.int32, device=dev)
    nodes = torch.arange(N, device=dev)
    # Per-step constants, vectorized over the steps (as som_train_plain).
    xiv = xc * iv
    A = xc[:, 0] * xiv[:, 0]
    for f in range(1, F):
        A = A + xc[:, f] * xiv[:, f]
    a1 = c32(0.5) * ((iv > 0).to(f32).sum(dim=1) - c32(1.0)) - c32(1.0)
    for s in range(T):
        it = pos * xiv[s]
        sh = (pos * pos) * iv[s]
        inter, shape = it[:, 0], sh[:, 0]
        for f in range(1, F):
            inter = inter + it[:, f]
            shape = shape + sh[:, f]
        chi2 = A[s] - inter * (inter / torch.maximum(shape, tiny))
        if dim_prior:
            score = a1[s] * torch.log(torch.maximum(chi2, tiny)) - half * chi2
        else:
            score = -half * chi2
        score = torch.where(torch.isnan(score), -torch.inf, score)
        score = torch.where(alive, score, neg)
        bmu = torch.argmax(score)
        score[bmu] = neg
        bmu2 = torch.argmax(score)
        # Edge refresh on both columns before the counter bump.
        ov = ov + _upsert(ids, sref, bmu, bmu2, c[bmu])
        ov = ov + _upsert(ids, sref, bmu2, bmu, c[bmu2])
        hold = ids == bmu
        nbr = hold.any(dim=1)
        is_bmu = nodes == bmu
        upd = torch.where(is_bmu, lb, zero) + torch.where(nbr, ln, zero)
        moved = pos + upd[:, None] * (xr[s] - pos)
        pos = torch.where((is_bmu | nbr)[:, None], moved, pos)
        sref = torch.where(hold, sref - 1, sref)
        c = c + is_bmu.to(c.dtype)
        err = err + torch.where(is_bmu, chi2[bmu], zero)
        if s % nbatch == 0:
            ids = torch.where((ids >= 0) & (c[:, None] - sref >= max_age),
                              -1, ids)
            alive = alive & (ids >= 0).any(dim=1)
            if int(alive.sum()) < N:
                err, pos, ov = _insert(pos, err, alive, ids, sref, c, ov,
                                       dec_new, half, zero)
        err = err * dec_all
    return pos, err, alive, ids, sref, c, int(ov)


def _insert(pos, err, alive, ids, sref, c, ov, dec_new, half, zero):
    """The insert of a batch update (networks.py:2129-2179): a node halfway
    between the largest-error node e1 and its largest-error neighbour e2
    (a column search), at the lowest dead index; `alive`, `ids` and `sref`
    change in place."""
    e1 = _argbest(err, alive)
    e2 = (_argbest(err, (ids == e1).any(dim=1)) if e1 != NONE else NONE)
    free = int(torch.argmax((~alive).to(torch.int32)))
    for e in {e1, e2} - {NONE}:
        err[e] = err[e] * dec_new
    err[free] = err[e1] if e1 != NONE else zero
    alive[free] = True
    p1 = pos[e1] if e1 != NONE else torch.zeros_like(pos[0])
    p2 = pos[e2] if e2 != NONE else torch.zeros_like(pos[0])
    pos[free] = half * (p1 + p2)
    if e1 != NONE:
        ids[e1] = torch.where(ids[e1] == e2, -1, ids[e1])
    if e2 != NONE:
        ids[e2] = torch.where(ids[e2] == e1, -1, ids[e2])
    ids[free] = -1
    ov = ov + _upsert(ids, sref, free, e1, c[free])
    ov = ov + _upsert(ids, sref, free, e2, c[free])
    for e in (e1, e2):
        if e != NONE:
            ov = ov + _upsert(ids, sref, e, free, c[e])
    return err, pos, ov


def _check_inputs(pos, err, alive, ids, sref, c, xc, iv, xr):
    if pos.ndim != 2 or xc.ndim != 2:
        raise ValueError("pos must be (N, F) and the draws (T, F)")
    N, F = pos.shape
    T = xc.shape[0]
    dev = pos.device
    _check("pos", pos, (N, F), dev)
    _check("err", err, (N,), dev)
    for name, t in (("xc", xc), ("iv", iv), ("xr", xr)):
        _check(name, t, (T, F), dev)
    for name, t, shape, dtype in (("alive", alive, (N,), torch.bool),
                                  ("ids", ids, (N, K), torch.int32),
                                  ("sref", sref, (N, K), torch.int32),
                                  ("c", c, (N,), torch.int32)):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"{name} must be a {dtype} tensor")
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name} must be {shape} on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if not 2 <= N <= MAX_NODES:
        raise ValueError(f"gng_train takes 2 to {MAX_NODES} nodes, got {N}")
    if not 1 <= F <= MAX_FILT:
        raise ValueError(f"gng_train takes 1 to {MAX_FILT} filters, got {F}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return N, F, T


def gng_train(pos, err, alive, ids, sref, c, overflow, xc, iv, xr, *,
              nbatch, max_age=15, learn_best=0.2, learn_neighbor=0.005,
              new_err_dec=0.5, all_err_dec=0.005, dim_prior=True,
              cluster=None):
    """Train the GNG state over the T draws in one kernel launch.

    `cluster` (card only): None lets `choose_cluster` pick the route, 1
    forces the block, K in CLUSTER_SIZES a cluster of K CTAs (raises
    where the CTA does not fit or the card cannot schedule it).
    Returns (pos, err, alive, ids, sref, c, overflow) in the input forms
    (overflow an int).
    """
    N, F, T = _check_inputs(pos, err, alive, ids, sref, c, xc, iv, xr)
    if int(nbatch) < 1 or int(max_age) < 0:
        raise ValueError("nbatch must be >= 1 and max_age >= 0")
    if cluster is not None and cluster != 1 and cluster not in CLUSTER_SIZES:
        raise ValueError(f"gng_train takes cluster=None, 1 or one of "
                         f"{CLUSTER_SIZES}, got {cluster}")
    kw = dict(nbatch=int(nbatch), max_age=int(max_age),
              learn_best=learn_best, learn_neighbor=learn_neighbor,
              new_err_dec=new_err_dec, all_err_dec=all_err_dec,
              dim_prior=dim_prior)
    if pos.device.type == "cpu":
        if cluster is not None:
            raise ValueError("cluster= picks a route on the card; a CPU "
                             "tensor runs the plain version")
        return gng_train_plain(pos, err, alive, ids, sref, c, overflow, xc,
                               iv, xr, **kw)
    dev = pos.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if cluster is None:
        cluster = choose_cluster({k: _active(index, N, F, k)
                                  for k in CLUSTER_SIZES})
    elif cluster > 1 and _active(index, N, F, cluster) < 1:
        raise ValueError(f"gng_train: no cluster of {cluster} CTAs at {N} "
                         f"nodes x {F} filters (shared memory or the card)")
    # A copy even where the transpose is already contiguous (F = 1): the
    # kernel trains it in place.
    posT = pos.t().clone(memory_format=torch.contiguous_format)
    err_o = err.clone()
    alive_o = alive.to(torch.int32)
    ids_o, sref_o, c_o = ids.clone(), sref.clone(), c.clone()
    ov = torch.tensor([int(overflow)], dtype=torch.int32, device=dev)
    sched = torch.empty((T, 2), dtype=torch.float32, device=dev)
    lib = _build.load()
    lb, ln, dn, da = _constants(learn_best, learn_neighbor, new_err_dec,
                                all_err_dec)
    args = (posT.data_ptr(), err_o.data_ptr(), alive_o.data_ptr(),
            ids_o.data_ptr(), sref_o.data_ptr(), c_o.data_ptr(),
            ov.data_ptr(), xc.data_ptr(), iv.data_ptr(), xr.data_ptr(),
            sched.data_ptr(), N, F, T, int(nbatch), int(max_age), lb, ln,
            dn, da, int(bool(dim_prior)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cluster > 1:
            rc = lib.fz_gng_train_cluster(*args, cluster_threads(N, cluster),
                                          int(cluster), stream)
        else:
            resident = int(lib.fz_gng_train_smem(N, F, 1) <= _SMEM_MAX)
            threads = min(_MAX_THREADS, max(_MIN_THREADS, -(-N // 32) * 32))
            rc = lib.fz_gng_train(*args, threads, resident, stream)
    if rc != 0:
        raise RuntimeError(f"gng_train launch (cluster {cluster}) failed: "
                           f"CUDA error {rc}")
    if cluster > 1:
        gng_train.cluster_launches += 1
    else:
        gng_train.launches += 1
    return (posT.t().contiguous(), err_o, alive_o != 0, ids_o, sref_o, c_o,
            int(ov.item()))


gng_train.launches = 0
gng_train.cluster_launches = 0


def reset_launch_counts():
    """Set both routes' launch counts to 0."""
    gng_train.launches = gng_train.cluster_launches = 0


def launch_counts():
    """{route: launches since the last reset}: ``gng_train`` the block
    route, ``gng_train_cluster`` the cluster route."""
    return {"gng_train": gng_train.launches,
            "gng_train_cluster": gng_train.cluster_launches}
