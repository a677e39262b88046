"""Wrapper and plain version of the population-chain kernel (K10).

`pop_chain` runs whole flat-prior population MH-in-Gibbs chains (or one
segment of them) in one launch of ``csrc/pop_chain.cu``, one thread block
per chain: the counterpart of the Pallas kernel `_make_pop_mega_kernel`
(frankenz_tpu/samplers/population.py:179); the design notes are in the
source.

Inputs, float32 contiguous tensors on one device:

* ``draws`` (nchains, T, 2 + 2 * mh_steps): per Gibbs step the pair
  (i, j) as floats, then `mh_steps` standard normals, then `mh_steps`
  unit exponentials (`samplers.population._pop_draws` makes one chain's
  table);
* ``pdfsT`` (Nbins, Nobs): the transposed per-object PDFs;
* the carry: ``pos`` (nchains, Nbins), the overlaps ``ov`` (nchains, Nobs)
  = pdfs . pos as the rank-1 updates left them, and ``lnp`` (nchains,).

Per Gibbs step (population.py:234-292): dcol = pdfsT[i] - pdfsT[j];
scale = 1e-4 min(pos_i, pos_j, 1 - pos_i, 1 - pos_j); the gradient
dlnl / scale along the pair, dlnl the sum over objects of
`_pair_dlnl_terms(ov, scale / 2 dcol)`; gscale = min(|1 / grad|,
|1e4 scale|) (|scale| where grad = 0); then `mh_steps` proposals
z = draw gscale, pos + t z with t = e_i - e_j, ov + z dcol, scored by
sum log(max(ov, 1e-30)), or -3.0e38 when a bin turns negative, and
accepted iff -e < lnp_new - lnp.  Every `thin`-th step writes pos and
lnp.  Returns (samples (nchains, T / thin, Nbins), lnps (nchains,
T / thin), pos, ov, lnp): the whole carry goes in and comes out, so
segments compose.

The log-sums decide every accept, so their order is part of the
function: `tree_sum`, a halving tree over the objects padded with zeros,
which the kernel walks as its threads own the objects (see the source).
The tree depends on the thread count, which `chain_threads` derives from
Nobs alone.

On the card a chain runs on one of two routes of the same source: one
thread block (``pop_chain_kernel``), or a thread-block cluster of K CTAs
that splits that block's warps (``pop_chain_cluster_kernel``, K = 2 to
16), which folds the same tree, so the two agree bit for bit and the
result does not depend on K.  `choose_cluster` picks K from the chain
count, the card's SM count and its schedulability query for this shape
(`cluster_sizes` lists the sizes a shape admits); ``cluster=`` forces one
(1: the block).  A refused cluster launch raises: there is no retry on
the block.

On a CPU tensor the wrapper runs `pop_chain_plain`; on a CUDA tensor it
launches the kernel or raises: there is no fallback.
``pop_chain.launches`` counts the block route's launches and
``pop_chain.cluster_launches`` the cluster route's (`launch_counts`
names them ``pop_chain`` and ``pop_chain_cluster``).  The plain version
makes the kernel's operations in its order, with every constant a tensor on the
inputs' device, so on the card the two agree bit for bit.
"""

from __future__ import annotations

import functools

import torch

from . import build as _build
from .cluster import CLUSTER_SIZES, max_active
from .fullmask import _SMEM_MAX, _check

__all__ = ["pop_chain", "pop_chain_plain", "tree_sum", "chain_threads",
           "cluster_sizes", "choose_cluster", "limits_reason", "MAX_BINS",
           "MAX_WIDTH", "MAX_OBS", "NEG", "CLUSTER_SIZES",
           "reset_launch_counts", "launch_counts"]

# The kernel's own limits: a warp holds the position in registers (4 bins
# a lane), a draw row is staged in shared memory, and the objects of a
# chain past shared memory stay in device memory.
MAX_BINS = 128
MAX_WIDTH = 128
MAX_OBS = 4_194_304
NEG = -3.0e38
_MIN_THREADS, _MAX_THREADS = 128, 1024


def chain_threads(nobs):
    """Threads of a chain's block: the power of two in [128, 1024] that
    gives a thread about 8 objects, 1,024 from 4,097 objects up."""
    want = -(-int(nobs) // 8)
    return min(_MAX_THREADS,
               max(_MIN_THREADS, 1 << max(want - 1, 0).bit_length()))


def _rows_per_thread(nobs, threads):
    """Rows of the (rows, threads) object layout, padded to a power of two
    and to the kernel's groups of 8."""
    rows = -(-int(nobs) // threads)
    return max(8, 1 << (rows - 1).bit_length())


def limits_reason(nbins, nobs, mh_steps):
    """Why the kernel does not take this shape, or None when it does."""
    if not 2 <= nbins <= MAX_BINS:
        return f"pop_chain takes 2 to {MAX_BINS} bins, got {nbins}"
    if not 1 <= nobs <= MAX_OBS:
        return f"pop_chain takes 1 to {MAX_OBS} objects, got {nobs}"
    if mh_steps < 1 or 2 + 2 * mh_steps > MAX_WIDTH:
        return (f"pop_chain takes draw rows of 4 to {MAX_WIDTH} values "
                f"(mh_steps 1 to {(MAX_WIDTH - 2) // 2}), got mh_steps "
                f"{mh_steps}")
    return None


@functools.lru_cache(maxsize=None)
def consts(dtype, device):
    """The constants of the chain as 0-d tensors of `dtype` on `device`,
    rounded from double as JAX rounds its weakly typed Python floats."""
    vals = dict(zero=0.0, half=0.5, one=1.0, two=2.0, third=1.0 / 3.0,
                small=1e-3, ok=1e-25, tiny=1e-30, step=1e-4, cap=1e4,
                neg=NEG)
    return {k: torch.tensor(v, dtype=dtype, device=device)
            for k, v in vals.items()}


def _log1p_f32(x):
    """log1p from log, multiply and select, as the JAX package writes it
    (population.py:71-77): the 3-term series x (1 - x (1/2 - x / 3)) for
    |x| < 1e-3, log(1 + x) above."""
    c = consts(x.dtype, x.device)
    small = torch.abs(x) < c["small"]
    series = x * (c["one"] - x * (c["half"] - x * c["third"]))
    return torch.where(small, series,
                       torch.log(c["one"] + torch.where(small, c["zero"], x)))


def _pair_dlnl_terms(ov, half):
    """Elementwise ln(ov + half) - ln(ov - half) without cancellation
    (population.py:80-100): log1p(2 half / (ov - half)) where
    ov - |half| > 1e-25, else the difference of the two logs, each
    floored at 1e-30."""
    c = consts(ov.dtype, ov.device)
    num = ov + half
    den = ov - half
    ok = ov - torch.abs(half) > c["ok"]
    fast = _log1p_f32((c["two"] * half) / torch.where(ok, den, c["one"]))
    slow = (torch.log(torch.maximum(num, c["tiny"]))
            - torch.log(torch.maximum(den, c["tiny"])))
    return torch.where(ok, fast, slow)


def _halve(v, dim):
    n = v.shape[dim]
    while n > 1:
        n //= 2
        v = v.narrow(dim, 0, n) + v.narrow(dim, n, n)
    return v


def tree_sum(v, threads):
    """Sum over the last axis in the kernel's order.  The objects, padded
    with zeros to rows x threads (object o = row * threads + thread),
    fold by halves: over the rows (a thread's own objects), over the 32
    lanes of each warp, over the warps (padded to 32 with zeros)."""
    nobs = v.shape[-1]
    lead = tuple(v.shape[:-1])
    rows = _rows_per_thread(nobs, threads)
    pad = rows * threads - nobs
    if pad:
        v = torch.cat([v, v.new_zeros(lead + (pad,))], dim=-1)
    v = _halve(v.reshape(lead + (rows, threads)), -2)
    v = _halve(v.reshape(lead + (threads // 32, 32)), -1)[..., 0]
    if threads < 1024:
        v = torch.cat([v, v.new_zeros(lead + (32 - threads // 32,))], dim=-1)
    return _halve(v, -1)[..., 0]


def cluster_sizes(nobs, width):
    """The cluster sizes the cluster route takes for chains of `nobs`
    objects and draw rows of `width` values: K divides the chain's warp
    count and a CTA's threads hold a draw row."""
    threads = chain_threads(nobs)
    return tuple(k for k in CLUSTER_SIZES
                 if k <= threads // 32 and width <= threads // k)


def choose_cluster(nchains, sm_count, active):
    """The cluster size for `nchains` chains: the largest K of `active`
    ({K: clusters of this shape the card holds at once, for the sizes whose
    CTA fits in shared memory}) with nchains x K CTAs within `sm_count`
    and all nchains clusters held at once; 1 (the block route) when none
    is."""
    ok = [k for k, n in active.items()
          if n >= nchains and nchains * k <= sm_count]
    return max(ok, default=1)


def _active(device_index, nobs, width, mh_steps, k):
    """Clusters of k CTAs for chains of `nobs` objects the card holds at
    once (0 when a CTA's objects do not fit in shared memory)."""
    threads = chain_threads(nobs)
    return max_active("pop_chain_cluster", device_index,
                      (nobs, threads, width, k),
                      (nobs, threads, width, mh_steps, k))


def pop_chain_plain(draws, pdfsT, pos, ov, lnp, *, thin, mh_steps):
    """Plain version of `pop_chain`: a step loop in torch, the chains a
    batch dimension, with the kernel's operations in its order."""
    nchains, T, _ = draws.shape
    nbins, nobs = pdfsT.shape
    threads = chain_threads(nobs)
    c = consts(pdfsT.dtype, pdfsT.device)
    pos, ov, lnp = pos.clone(), ov.clone(), lnp.clone()
    samples = pos.new_empty((nchains, T // thin, nbins))
    lnps = pos.new_empty((nchains, T // thin))
    bins = torch.arange(nbins, device=pos.device)
    for s in range(T):
        row = draws[:, s]
        i = row[:, 0].long().clamp(0, nbins - 1)
        j = row[:, 1].long().clamp(0, nbins - 1)
        dcol = pdfsT[i] - pdfsT[j]
        t = ((bins == i[:, None]).to(pos.dtype)
             - (bins == j[:, None]).to(pos.dtype))
        pi = pos.gather(1, i[:, None])[:, 0]
        pj = pos.gather(1, j[:, None])[:, 0]
        scale = c["step"] * torch.minimum(
            torch.minimum(pi, pj),
            torch.minimum(c["one"] - pi, c["one"] - pj))
        half = (scale / c["two"])[:, None] * dcol
        dlnl = tree_sum(_pair_dlnl_terms(ov, half), threads)
        grad = dlnl / scale
        gscale = torch.where(
            grad != c["zero"],
            torch.minimum(torch.abs(c["one"] / grad),
                          torch.abs(scale * c["cap"])),
            torch.abs(scale))
        for k in range(mh_steps):
            z = row[:, 2 + k] * gscale
            e = row[:, 2 + mh_steps + k]
            pos_n = pos + t * z[:, None]
            ov_n = ov + z[:, None] * dcol
            lnp_n = tree_sum(torch.log(torch.maximum(ov_n, c["tiny"])),
                             threads)
            bad = (pos_n < c["zero"]).any(dim=1)
            lnp_n = torch.where(bad, c["neg"], lnp_n)
            accept = -e < (lnp_n - lnp)
            pos = torch.where(accept[:, None], pos_n, pos)
            ov = torch.where(accept[:, None], ov_n, ov)
            lnp = torch.where(accept, lnp_n, lnp)
        if s % thin == thin - 1:
            samples[:, s // thin] = pos
            lnps[:, s // thin] = lnp
    return samples, lnps, pos, ov, lnp


def _check_inputs(draws, pdfsT, pos, ov, lnp, thin, mh_steps):
    if draws.ndim != 3 or pdfsT.ndim != 2:
        raise ValueError("draws must be (nchains, T, 2 + 2 * mh_steps) and "
                         "pdfsT (Nbins, Nobs)")
    nchains, T, width = draws.shape
    nbins, nobs = pdfsT.shape
    dev = pdfsT.device
    _check("draws", draws, (nchains, T, width), dev)
    _check("pdfsT", pdfsT, (nbins, nobs), dev)
    _check("pos", pos, (nchains, nbins), dev)
    _check("ov", ov, (nchains, nobs), dev)
    _check("lnp", lnp, (nchains,), dev)
    if width != 2 + 2 * int(mh_steps):
        raise ValueError(f"draw rows hold {width} values, expected "
                         f"2 + 2 * mh_steps = {2 + 2 * int(mh_steps)}")
    reason = limits_reason(nbins, nobs, int(mh_steps))
    if reason:
        raise ValueError(reason)
    if nchains < 1 or T < 1 or int(thin) < 1 or T % int(thin):
        raise ValueError(f"need at least one chain and T >= 1 a multiple of "
                         f"thin, got nchains {nchains}, T {T}, thin {thin}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return nchains, T, width, nbins, nobs


def pop_chain(draws, pdfsT, pos, ov, lnp, *, thin, mh_steps, resident=None,
              cluster=None):
    """Run T Gibbs steps of every chain in one kernel launch.

    `resident` (card only) keeps each chain's overlaps and pair direction
    in shared memory; the default takes it when they fit, and the two
    variants agree bit for bit.  `cluster` (card only): None lets
    `choose_cluster` pick the route, 1 forces the block, K in
    `cluster_sizes` a cluster of K CTAs a chain (resident; raises where
    the card cannot schedule it).  Returns (samples, lnps, pos, ov, lnp).
    """
    nchains, T, width, nbins, nobs = _check_inputs(draws, pdfsT, pos, ov,
                                                   lnp, thin, mh_steps)
    thin, mh_steps = int(thin), int(mh_steps)
    if cluster is not None and cluster != 1 and cluster not in cluster_sizes(
            nobs, width):
        raise ValueError(f"pop_chain takes cluster=None, 1 or one of "
                         f"{cluster_sizes(nobs, width)} at {nobs} objects "
                         f"and draw rows of {width}, got {cluster}")
    if cluster is not None and cluster != 1 and resident is False:
        raise ValueError("the cluster route keeps the chains resident: "
                         "cluster > 1 with resident=False")
    if pdfsT.device.type == "cpu":
        if cluster is not None:
            raise ValueError("cluster= picks a route on the card; a CPU "
                             "tensor runs the plain version")
        return pop_chain_plain(draws, pdfsT, pos, ov, lnp, thin=thin,
                               mh_steps=mh_steps)
    dev = pdfsT.device
    threads = chain_threads(nobs)
    lib = _build.load()
    samples = torch.empty((nchains, T // thin, nbins), dtype=torch.float32,
                          device=dev)
    lnps = torch.empty((nchains, T // thin), dtype=torch.float32, device=dev)
    pos_o, ov_o, lnp_o = (torch.empty_like(x) for x in (pos, ov, lnp))
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if cluster is None and resident is not False:
        active = {k: _active(index, nobs, width, mh_steps, k)
                  for k in cluster_sizes(nobs, width)}
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        cluster = choose_cluster(nchains, sms, active)
    if cluster is not None and cluster > 1:
        if _active(index, nobs, width, mh_steps, cluster) < 1:
            raise ValueError(f"pop_chain: the card schedules no cluster of "
                             f"{cluster} CTAs at {nobs} objects")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.fz_pop_chain_cluster(
                draws.data_ptr(), pdfsT.data_ptr(), pos.data_ptr(),
                ov.data_ptr(), lnp.data_ptr(), samples.data_ptr(),
                lnps.data_ptr(), pos_o.data_ptr(), ov_o.data_ptr(),
                lnp_o.data_ptr(), nchains, T, width, nbins, nobs, thin,
                mh_steps, threads, int(cluster), stream)
        if rc != 0:
            raise RuntimeError(f"pop_chain cluster launch (K={cluster}) "
                               f"failed: CUDA error {rc}")
        pop_chain.cluster_launches += 1
        return samples, lnps, pos_o, ov_o, lnp_o
    fits = lib.fz_pop_chain_smem(nobs, threads, width, 1) <= _SMEM_MAX
    if resident is None:
        resident = fits
    elif resident and not fits:
        raise ValueError(f"{nobs} objects do not fit in shared memory")
    dcol = None if resident else torch.empty_like(ov)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fz_pop_chain(
            draws.data_ptr(), pdfsT.data_ptr(), pos.data_ptr(),
            ov.data_ptr(), lnp.data_ptr(), samples.data_ptr(),
            lnps.data_ptr(), pos_o.data_ptr(), ov_o.data_ptr(),
            lnp_o.data_ptr(), dcol.data_ptr() if dcol is not None else None,
            nchains, T, width, nbins, nobs, thin, mh_steps, threads,
            int(bool(resident)), stream)
    if rc != 0:
        raise RuntimeError(f"pop_chain launch failed: CUDA error {rc}")
    pop_chain.launches += 1
    return samples, lnps, pos_o, ov_o, lnp_o


pop_chain.launches = 0
pop_chain.cluster_launches = 0


def reset_launch_counts():
    """Set both routes' launch counts to 0."""
    pop_chain.launches = pop_chain.cluster_launches = 0


def launch_counts():
    """{route: launches since the last reset}: ``pop_chain`` the block
    route, ``pop_chain_cluster`` the cluster route."""
    return {"pop_chain": pop_chain.launches,
            "pop_chain_cluster": pop_chain.cluster_launches}
