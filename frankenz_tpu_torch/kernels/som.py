"""Wrapper and plain version of the SOM training kernel (K8).

`som_train` runs a whole SelfOrganizingMap training run in one launch of
``csrc/som_train.cu``, the counterpart of the Pallas kernel
`_make_som_mega_kernel` (frankenz_tpu/models/networks.py:1280); the
design notes are in the source.

Inputs, float32 contiguous tensors on one device:

* ``nodes``: (N, F) initial node table; ``pos``: (N, P) lattice positions;
* ``xc``, ``iv``, ``xr``: (T, F) the draws of the T steps, pre-gathered
  and cleaned (bad bands: xc = 0 and iv = 0), and the raw photometry the
  update moves the nodes toward;

and the schedules as `schedule(name, start, end)` tuples.  Returns the
trained (N, F) table and, with ``return_bmu``, the (T,) int32 best node
of every step.

On the card the run takes one of two routes of the same source: one
thread block (``som_train_kernel``, its node table in shared memory when
it fits), or a thread-block cluster of K CTAs on K SMs
(``som_train_cluster_kernel``, K = 2 to 16), each CTA holding the node
columns it owns in its shared memory.  The two agree bit for bit.
`choose_cluster` picks K from the sizes whose CTA fits in shared memory
and the card's schedulability query (the rule of `kernels.cluster`); with
none the run takes the block; ``cluster=`` forces a route (1: the
block).  A refused cluster launch raises: there is no retry on the
block.

On a CPU tensor the wrapper runs `som_train_plain`; on a CUDA tensor it
launches the kernel or raises: there is no fallback.
``som_train.launches`` counts the block route's launches and
``som_train.cluster_launches`` the cluster route's (`launch_counts` names
them ``som_train`` and ``som_train_cluster``).  The plain version makes
the kernel's operations in its order, with every constant a tensor on
the inputs' device (a CUDA division by a host scalar multiplies by its
reciprocal), so on the card the two agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build as _build
from .cluster import CLUSTER_ORDER, CLUSTER_SIZES, choose_cluster, \
    cluster_threads, max_active
from .fullmask import _SMEM_MAX, _check

__all__ = ["som_train", "som_train_plain", "schedule", "choose_cluster",
           "cluster_threads", "MAX_NODES", "MAX_FILT", "MAX_PROJ",
           "LEARN_KINDS", "CLUSTER_SIZES", "CLUSTER_ORDER",
           "reset_launch_counts", "launch_counts"]

# The kernel's own limits: the table stays in device memory past shared
# memory, so the node cap is the JAX eligibility rule's largest lattice
# (networks.py:1583, 32,768 nodes), at every filter count it admits.
MAX_NODES = 32768
MAX_FILT = 120
MAX_PROJ = 8
LEARN_KINDS = {"linear": 0, "geometric": 1, "harmonic": 2}
_MIN_THREADS, _MAX_THREADS = 128, 1024


def schedule(name, start, end):
    """A learning-rate or width schedule as the kernel takes it: (kind,
    start, end, log start, log end), float32; the logs (geometric only)
    are rounded from double, as JAX rounds its weakly typed constants."""
    kind = LEARN_KINDS[name]
    logs = ((np.log(start), np.log(end)) if kind == 1 else (0.0, 0.0))
    return (kind, float(np.float32(start)), float(np.float32(end)),
            float(np.float32(logs[0])), float(np.float32(logs[1])))


def _active(device_index, N, F, P, k):
    """Clusters of k CTAs at N nodes x F filters x P lattice dimensions
    the card holds at once (0 when the CTA does not fit in shared
    memory)."""
    return max_active("som_train_cluster", device_index, (N, F, P, k),
                      (N, F, P, k, cluster_threads(N, k)))


def _inv_t(nsteps_total):
    return float(np.float32(1.0 / float(max(int(nsteps_total) - 1, 1))))


def _learn_plain(sched, t, c):
    kind, start, end, lstart, lend = sched
    omt = c(1.0) - t
    if kind == 0:
        return omt * c(start) + t * c(end)
    if kind == 1:
        return torch.exp(omt * c(lstart) + t * c(lend))
    return c(1.0) / (omt / c(start) + t / c(end))


def som_train_plain(nodes, pos, xc, iv, xr, *, nside, wt_thresh,
                    lr, nb, lorentz=False, dim_prior=True, off=0.0,
                    nsteps_total=None, return_bmu=False):
    """Plain version of `som_train`: a step loop in torch with the
    kernel's operations in its order; it keeps the reduction max(wt)
    that the kernel knows to be 1."""
    dev = nodes.device
    f32 = torch.float32
    T, F = xc.shape
    nsteps_total = T if nsteps_total is None else nsteps_total

    def c(v):
        return torch.tensor(np.float32(v), dtype=f32, device=dev)

    nd = nodes.clone()
    # Per-step constants, vectorized over the steps: the same operations,
    # rounded the same way, as one step's scalars.
    xiv = xc * iv
    A = xc[:, 0] * xiv[:, 0]
    for f in range(1, F):
        A = A + xc[:, f] * xiv[:, f]
    ndim = (iv > 0).to(f32).sum(dim=1)
    a1 = c(0.5) * (ndim - c(1.0)) - c(1.0)
    t = (c(off) + torch.arange(T, dtype=f32, device=dev)) * c(
        _inv_t(nsteps_total))
    s2 = _learn_plain(nb, t, c) * c(nside)
    s2 = s2 * s2
    rate = _learn_plain(lr, t, c)
    tiny, half, thr = c(1e-30), c(0.5), c(wt_thresh)
    zero = c(0.0)
    bmus = torch.empty(T, dtype=torch.int64, device=dev)
    for s in range(T):
        it = nd * xiv[s]
        sh = (nd * nd) * iv[s]
        inter, shape = it[:, 0], sh[:, 0]
        for f in range(1, F):
            inter = inter + it[:, f]
            shape = shape + sh[:, f]
        chi2 = A[s] - inter * (inter / torch.maximum(shape, tiny))
        if dim_prior:
            score = a1[s] * torch.log(torch.maximum(chi2, tiny)) - half * chi2
        else:
            score = -half * chi2
        b = torch.argmax(score)
        bmus[s] = b
        diff = pos - pos[b]
        sqd = (diff * diff).sum(dim=1)  # lattice integers: exact
        if lorentz:
            wt = s2[s] / (sqd + s2[s])
        else:
            wt = torch.exp((-half * sqd) / s2[s])
        # A node the step leaves alone keeps its value by selection: a
        # zero multiple of (xr - node) would carry a NaN of a masked band.
        keep = wt > thr * wt.amax()
        u = torch.where(keep, rate[s] * wt, zero)
        nd = torch.where(keep[:, None], nd + u[:, None] * (xr[s] - nd), nd)
    return nd, (bmus.to(torch.int32) if return_bmu else None)


def _check_inputs(nodes, pos, xc, iv, xr):
    if nodes.ndim != 2 or pos.ndim != 2 or xc.ndim != 2:
        raise ValueError("nodes must be (N, F), pos (N, P) and the draws "
                         "(T, F)")
    N, F = nodes.shape
    P = pos.shape[1]
    T = xc.shape[0]
    dev = nodes.device
    _check("nodes", nodes, (N, F), dev)
    _check("pos", pos, (N, P), dev)
    for name, t in (("xc", xc), ("iv", iv), ("xr", xr)):
        _check(name, t, (T, F), dev)
    if not 1 <= N <= MAX_NODES:
        raise ValueError(f"som_train takes 1 to {MAX_NODES} nodes, got {N}")
    if not 1 <= F <= MAX_FILT:
        raise ValueError(f"som_train takes 1 to {MAX_FILT} filters, got {F}")
    if not 1 <= P <= MAX_PROJ:
        raise ValueError(f"som_train takes 1 to {MAX_PROJ} lattice "
                         f"dimensions, got {P}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return N, F, P, T


def som_train(nodes, pos, xc, iv, xr, *, nside, wt_thresh, lr, nb,
              lorentz=False, dim_prior=True, off=0.0, nsteps_total=None,
              return_bmu=False, cluster=None):
    """Train the (N, F) node table over the T draws in one kernel launch.

    `lr` and `nb` are `schedule(...)` tuples of the learning rate and the
    neighbourhood width (sigma = nb(t) * nside); `lorentz` picks the
    Lorentzian neighbourhood over the Gaussian; `off` is the global index
    of the first step and `nsteps_total` the whole run's length (default
    T), so that runs cut into segments walk the schedules as one.
    `cluster` (card only): None lets `choose_cluster` pick the route, 1
    forces the block, K in CLUSTER_SIZES a cluster of K CTAs (raises
    where the CTA does not fit or the card cannot schedule it).
    Returns (nodes (N, F), bmu (T,) int32 or None).
    """
    N, F, P, T = _check_inputs(nodes, pos, xc, iv, xr)
    if cluster is not None and cluster != 1 and cluster not in CLUSTER_SIZES:
        raise ValueError(f"som_train takes cluster=None, 1 or one of "
                         f"{CLUSTER_SIZES}, got {cluster}")
    nsteps_total = T if nsteps_total is None else int(nsteps_total)
    kw = dict(nside=nside, wt_thresh=wt_thresh, lr=lr, nb=nb,
              lorentz=lorentz, dim_prior=dim_prior, off=off,
              nsteps_total=nsteps_total, return_bmu=return_bmu)
    if nodes.device.type == "cpu":
        if cluster is not None:
            raise ValueError("cluster= picks a route on the card; a CPU "
                             "tensor runs the plain version")
        return som_train_plain(nodes, pos, xc, iv, xr, **kw)
    dev = nodes.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if cluster is None:
        cluster = choose_cluster({k: _active(index, N, F, P, k)
                                  for k in CLUSTER_SIZES})
    elif cluster > 1 and _active(index, N, F, P, cluster) < 1:
        raise ValueError(f"som_train: no cluster of {cluster} CTAs at {N} "
                         f"nodes x {F} filters (shared memory or the card)")
    # A copy even where the transpose is already contiguous (F = 1): the
    # kernel trains it in place.
    nodesT = nodes.t().clone(memory_format=torch.contiguous_format)
    posT = pos.t().contiguous()
    sched = torch.empty((T, 4), dtype=torch.float32, device=dev)
    bmu = (torch.empty(T, dtype=torch.int32, device=dev)
           if return_bmu else None)
    lib = _build.load()
    args = (nodesT.data_ptr(), posT.data_ptr(), xc.data_ptr(),
            iv.data_ptr(), xr.data_ptr(), sched.data_ptr(),
            bmu.data_ptr() if bmu is not None else None, N, F, P, T,
            float(np.float32(off)), nsteps_total, float(np.float32(nside)),
            float(np.float32(wt_thresh)), int(bool(dim_prior)),
            int(bool(lorentz)), *lr, *nb)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cluster > 1:
            rc = lib.fz_som_train_cluster(*args, cluster_threads(N, cluster),
                                          int(cluster), stream)
        else:
            resident = int(lib.fz_som_train_smem(N, F, P, 1) <= _SMEM_MAX)
            threads = min(_MAX_THREADS, max(_MIN_THREADS, -(-N // 32) * 32))
            rc = lib.fz_som_train(*args, threads, resident, stream)
    if rc != 0:
        raise RuntimeError(f"som_train launch (cluster {cluster}) failed: "
                           f"CUDA error {rc}")
    if cluster > 1:
        som_train.cluster_launches += 1
    else:
        som_train.launches += 1
    return nodesT.t().contiguous(), bmu


som_train.launches = 0
som_train.cluster_launches = 0


def reset_launch_counts():
    """Set both routes' launch counts to 0."""
    som_train.launches = som_train.cluster_launches = 0


def launch_counts():
    """{route: launches since the last reset}: ``som_train`` the block
    route, ``som_train_cluster`` the cluster route."""
    return {"som_train": som_train.launches,
            "som_train_cluster": som_train.cluster_launches}
