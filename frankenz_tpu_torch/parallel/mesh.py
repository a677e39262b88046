"""
Device meshes and sharded execution of the fit pipelines (port of
`frankenz_tpu.parallel.mesh`).

Photo-z fitting is data parallel over *objects*: each object's posterior
and PDF is independent, so the natural layout is a 1-D mesh with objects
sharded and the model set and kernel matrix replicated on every device.
The fit path has no communication; a sum over objects (the stacked N(z))
is the one reduction.  For model sets too large to replicate, the model
axis shards too (`model_sharded_fit_predict_step` on a 2-D mesh, and
`ring_fit_predict_step`, which rotates the model shards around a 1-D
mesh).

The port keeps JAX's single-controller model: one process drives every
device of its `Mesh`, and the entry points hand back whole results.  A
`Sharded` is the counterpart of a sharded `jax.Array`: the per-device
tensors in shard order, on their devices.  Each shard runs the port's
single-device code on its device (the CUDA kernels on the card, their
plain versions on the CPU); the reductions across shards are written out
in shard order.

A mesh may name one device more than once (``devices=["cpu"] * 8`` or
``[torch.device("cuda:0")] * 4``).  That is the port's counterpart of
JAX's ``--xla_force_host_platform_device_count``: torch has a single
`cpu` device, so the CPU tests build their 8-shard mesh this way, and
one card can run a 4-shard mesh.  Shards on one device share the copies
of replicated tensors, and a move between them is a no-op.

Across processes (`parallel.distributed`), each process's `Mesh` holds
its own devices; `process_index` / `process_count` place its shards in
the global object axis, and `stacked_nz` adds the processes' partial sums
with one `torch.distributed.all_reduce`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kde as _kde
from ..ops import likelihood as _like

__all__ = ["Mesh", "Sharded", "make_mesh", "make_mesh_2d", "shard_objects",
           "shard_models", "replicate", "sharded_logprob",
           "sharded_fit_predict_step", "model_sharded_fit_predict_step",
           "ring_fit_predict_step", "stacked_nz", "check_mesh"]

OBJ_AXIS = "objects"
MODEL_AXIS = "models"


def _process_topology():
    """(process_index, process_count) of the torch.distributed group, or
    (0, 1) when none is initialized."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """The devices this process drives, in shard order, with the mesh's
    shape and axis names (``("objects",)`` or ``("objects", "models")``;
    on a 2-D mesh shard (i, j) is ``devices[i * shape[1] + j]``)."""

    def __init__(self, devices, shape, axis_names):
        self.devices = tuple(torch.device(d) for d in devices)
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.size = len(self.devices)
        if int(np.prod(self.shape)) != self.size:
            raise ValueError(f"mesh shape {self.shape} does not hold "
                             f"{self.size} devices")
        self.process_index, self.process_count = _process_topology()

    def distinct_devices(self):
        """The mesh's devices without repeats, in first-seen order."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, axis_names={self.axis_names}, "
                f"devices={[str(d) for d in self.devices]}, "
                f"process {self.process_index}/{self.process_count})")


def check_mesh(mesh):
    """Raise TypeError unless `mesh` is a `Mesh` (what `mesh=` takes)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= takes a frankenz_tpu_torch.parallel.Mesh "
                        f"(make_mesh / make_mesh_2d), got "
                        f"{type(mesh).__name__}")
    return mesh


def _default_devices():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "make_mesh: no CUDA device is available.  For a mesh on the "
            "CPU name its devices, e.g. make_mesh(devices=['cpu'] * 8) "
            "(a device may repeat)")
    return [torch.device("cuda", i) for i in range(n)]


def _platform(devices):
    return torch.device(devices[0]).type if devices else "none"


def make_mesh(n_devices=None, devices=None):
    """1-D mesh over `objects` on the first `n_devices` devices.

    The devices are this process's CUDA devices unless `devices` names
    them (a device may repeat).  Raises ValueError when fewer devices
    exist than requested, and RuntimeError without a card and without
    `devices`.
    """
    devices = list(_default_devices() if devices is None else devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"make_mesh: requested {n_devices} devices but only "
                f"{len(devices)} available on platform "
                f"'{_platform(devices)}'.  For a mesh of repeated devices "
                f"pass devices=[device] * {n_devices}.")
        devices = devices[:n_devices]
    return Mesh(devices, (len(devices),), (OBJ_AXIS,))


def make_mesh_2d(n_obj, n_model, devices=None):
    """2-D (objects, models) mesh: shard (i, j) on
    ``devices[i * n_model + j]``."""
    devices = list(_default_devices() if devices is None else devices)
    n = n_obj * n_model
    if len(devices) < n:
        raise ValueError(
            f"make_mesh_2d: requested {n_obj}x{n_model}={n} devices but "
            f"only {len(devices)} available on platform "
            f"'{_platform(devices)}'.  For a mesh of repeated devices pass "
            f"devices=[device] * {n}.")
    return Mesh(devices[:n], (n_obj, n_model), (OBJ_AXIS, MODEL_AXIS))


class Sharded:
    """A global array as the tensors of this process's shards.

    `shards[k]` lives on ``mesh.devices[k]``.  `axis` names the mesh axis
    the leading dimension is split over (``"objects"``, ``"models"``) or
    is None for a replicated array; on a 2-D mesh an array split over one
    axis is repeated along the other.  `global_shape` is the whole
    array's shape across processes.
    """

    def __init__(self, mesh, shards, axis, global_shape):
        self.mesh = mesh
        self.shards = list(shards)
        self.axis = axis
        self.global_shape = tuple(global_shape)
        self.is_fully_addressable = mesh.process_count == 1

    @property
    def shape(self):
        return self.global_shape

    def block_ids(self):
        """Each shard's block index along the split axis."""
        return _block_ids(self.mesh, self.axis)

    def blocks(self):
        """One shard per block, in block order."""
        seen = {}
        for k, b in enumerate(self.block_ids()):
            seen.setdefault(b, self.shards[k])
        return [seen[b] for b in sorted(seen)]

    def global_rows(self, k):
        """The global leading-axis slice that shard `k` holds."""
        if self.axis is None:
            return slice(0, self.global_shape[0])
        nblock = len(self.blocks())
        per = self.shards[k].shape[0]
        b = self.block_ids()[k] + self.mesh.process_index * nblock
        return slice(b * per, (b + 1) * per)

    def numpy(self):
        """The whole array on the host (shards concatenated in order)."""
        if not self.is_fully_addressable:
            raise RuntimeError("Sharded.numpy(): the array spans "
                               f"{self.mesh.process_count} processes and "
                               "is not fully addressable here")
        if self.axis is None:
            return self.shards[0].cpu().numpy()
        return torch.cat([b.cpu() for b in self.blocks()]).numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)

    def __repr__(self):
        return (f"Sharded(shape={self.global_shape}, axis={self.axis}, "
                f"shards={len(self.shards)})")


def _block_ids(mesh, axis):
    """Shard k's block index along `axis` (0 for a replicated array)."""
    if axis is None:
        return [0] * mesh.size
    n_model = mesh.shape[1] if len(mesh.shape) == 2 else 1
    if axis == MODEL_AXIS:
        return [k % n_model for k in range(mesh.size)]
    return [k // n_model for k in range(mesh.size)]


def _tensor(x):
    """`x` as a tensor: tensors as they are (no copy to the host), a
    `Sharded` gathered on the host, host arrays copied."""
    if isinstance(x, Sharded):
        return torch.as_tensor(x.numpy())
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x))


def per_device(devices, fn):
    """`fn(device)` once per distinct device of `devices`, as a list in
    their order (shards on one device share the result)."""
    cache = {d: fn(d) for d in dict.fromkeys(devices)}
    return [cache[d] for d in devices]


def to_device(x, device):
    """`x` (a tensor, or tuples of tensors and scalars) on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        return tuple(to_device(v, device) for v in x)
    return x


def _split(mesh, x, axis):
    x = _tensor(x)
    nblock = mesh.shape[mesh.axis_names.index(axis)]
    if x.shape[0] % nblock:
        raise ValueError(f"leading dimension {x.shape[0]} does not split "
                         f"into {nblock} equal '{axis}' blocks")
    per = x.shape[0] // nblock
    shards = [x[b * per:(b + 1) * per].to(d) for b, d in
              zip(_block_ids(mesh, axis), mesh.devices)]
    return Sharded(mesh, shards, axis, x.shape)


def _one_or_tuple(out):
    return out[0] if len(out) == 1 else out


def shard_objects(mesh, *arrays):
    """Place arrays with their leading (object) axis split into equal
    contiguous blocks over the mesh's object axis."""
    return _one_or_tuple(tuple(_split(mesh, a, OBJ_AXIS) for a in arrays))


def shard_models(mesh, *arrays):
    """Place arrays with their leading (model) axis split over the 2-D
    mesh's model axis (repeated along the object axis)."""
    return _one_or_tuple(tuple(_split(mesh, a, MODEL_AXIS) for a in arrays))


def replicate(mesh, *arrays):
    """Place arrays whole on every shard: one copy per distinct device,
    shared by the shards on that device."""
    out = []
    for a in arrays:
        x = _tensor(a)
        out.append(Sharded(mesh, per_device(mesh.devices, x.to), None,
                           x.shape))
    return _one_or_tuple(tuple(out))


def _as_sharded(mesh, x, axis):
    """`x` laid out as `axis` on `mesh` (a matching `Sharded` as it is)."""
    if (isinstance(x, Sharded) and x.axis == axis
            and len(x.shards) == mesh.size
            and all(s.device == d for s, d in zip(x.shards, mesh.devices))):
        return x
    if axis is None:
        return replicate(mesh, x)
    return _split(mesh, x, axis)


def _collect(mesh, parts, axis, rows):
    """Per-shard tuples of outputs -> a tuple of `Sharded` (None fields
    stay None).  `rows` is the global leading size of split outputs."""
    out = []
    for field in zip(*parts):
        if field[0] is None:
            out.append(None)
            continue
        shape = (rows,) + tuple(field[0].shape[1:])
        out.append(Sharded(mesh, field, axis, shape))
    return tuple(out)


def sharded_logprob(mesh, lprob_func=None):
    """Object-sharded batched lprob evaluator.

    Returns ``f(data, data_err, data_mask, models, models_err,
    models_mask) -> LogprobResult`` of `Sharded` fields: the data split
    over objects, the models replicated, `lprob_func` (default
    `ops.likelihood.logprob`) run on each shard's device.  No collective.
    """
    func = lprob_func or _like.logprob

    def f(d, de, dm, m, me, mm):
        ds = [_as_sharded(mesh, x, OBJ_AXIS) for x in (d, de, dm)]
        ms = [_as_sharded(mesh, x, None) for x in (m, me, mm)]
        parts = [tuple(func(*(x.shards[k] for x in ds + ms)))
                 for k in range(mesh.size)]
        return _like.LogprobResult(*_collect(mesh, parts, OBJ_AXIS,
                                             ds[0].global_shape[0]))

    return f


def sharded_fit_predict_step(mesh, lprob_func=None, wt_thresh=1e-3,
                             cdf_thresh=2e-4):
    """Object-sharded fit -> PDF step.

    ``f(data, data_err, data_mask, models, models_err, models_mask, G)
    -> (pdfs, lmap, levid)`` as `Sharded` over objects; the model set and
    kernel matrix replicate.  Each shard runs `lprob_func` (default
    `ops.likelihood.logprob`) and `ops.kde.lnprob_pdf` (max, logsumexp,
    `kde_stack`) on its device: the fitters' plain composition, with no
    collective.
    """
    func = lprob_func or _like.logprob

    def f(d, de, dm, m, me, mm, G):
        ds = [_as_sharded(mesh, x, OBJ_AXIS) for x in (d, de, dm)]
        ms = [_as_sharded(mesh, x, None) for x in (m, me, mm, G)]
        parts = []
        for k in range(mesh.size):
            res = func(*(x.shards[k] for x in ds + ms[:3]))
            pdf, lmap, levid = _kde.lnprob_pdf(res[2], ms[3].shards[k],
                                               wt_thresh, cdf_thresh)
            parts.append((_kde.norm_rows(pdf), lmap, levid))
        return _collect(mesh, parts, OBJ_AXIS, ds[0].global_shape[0])

    return f


def _lnprob_fn(dim_prior, ignore_model_err):
    def lnp_of(d, de, dm, m, me, mm):
        return _like.logprob(d, de, dm, m, me, mm, dim_prior=dim_prior,
                             ignore_model_err=ignore_model_err).lnprob
    return lnp_of


def model_sharded_fit_predict_step(mesh, wt_thresh=1e-3, dim_prior=True,
                                   ignore_model_err=False):
    """Fit -> PDF step with objects AND models sharded (2-D mesh).

    Shard (i, j) computes its (B_i, M_j) log-posterior block against its
    model shard.  Over the model axis: lmap is the max of the shards'
    maxima; levid is ``log(sum of the shards' exp-sums) + lmap``, the
    partial sums added in shard order; the PDF is the sum, in shard
    order, of each shard's thresholded local weights @ its local G
    (`ops.kde.fp32_matmul`).  Returns (pdfs, lmap, levid) as `Sharded`
    over objects, each object block's result on every device of its row.
    """
    if len(mesh.shape) != 2:
        raise ValueError("model_sharded_fit_predict_step needs a 2-D "
                         "(objects, models) mesh (make_mesh_2d)")
    n_obj, n_model = mesh.shape
    lnp_of = _lnprob_fn(dim_prior, ignore_model_err)

    def f(d, de, dm, m, me, mm, G):
        ds = [_as_sharded(mesh, x, OBJ_AXIS) for x in (d, de, dm)]
        ms = [_as_sharded(mesh, x, MODEL_AXIS) for x in (m, me, mm, G)]
        parts = [None] * mesh.size
        for i in range(n_obj):
            ks = [i * n_model + j for j in range(n_model)]
            home = mesh.devices[ks[0]]
            lnps = [lnp_of(*(x.shards[k] for x in ds + ms[:3]))
                    for k in ks]
            lmap = torch.stack([lnp.amax(dim=1).to(home)
                                for lnp in lnps]).amax(dim=0)
            total = None
            for lnp in lnps:
                s = torch.exp(lnp - lmap.to(lnp.device)[:, None]).sum(
                    dim=1).to(home)
                total = s if total is None else total + s
            levid = torch.log(total) + lmap
            pdf = None
            for k, lnp in zip(ks, lnps):
                lm, lv = lmap.to(lnp.device), levid.to(lnp.device)
                wt = torch.exp(lnp - lv[:, None])
                if wt_thresh is not None:
                    keep = lnp > np.log(wt_thresh) + lm[:, None]
                    wt = torch.where(keep, wt, 0.0)
                part = _kde.fp32_matmul(
                    wt, ms[3].shards[k].to(wt.dtype)).to(home)
                pdf = part if pdf is None else pdf + part
            out = (_kde.norm_rows(pdf), lmap, levid)
            for k in ks:
                parts[k] = tuple(t.to(mesh.devices[k]) for t in out)
        return _collect(mesh, parts, OBJ_AXIS, ds[0].global_shape[0])

    return f


def ring_fit_predict_step(mesh, wt_thresh=1e-3, dim_prior=True,
                          ignore_model_err=False):
    """Ring-rotation fit -> PDF step on a 1-D mesh: objects AND models
    both split over the same axis, the model shards rotating one device
    along the ring per step (`.to(next device, non_blocking=True)`; a
    no-op between shards of one device).

    In step s shard k holds model shard (k - s) mod n, as JAX's
    `ppermute` ring.  ``wt_thresh`` set: pass A rotates n times with a
    running max and rescaled sum-exp per object (exact lmap, levid), pass
    B rotates again and stacks the weights thresholded against the final
    lmap.  ``wt_thresh=None``: one rotation with a rescaled PDF
    accumulator.  The running max starts at float32's finite minimum (no
    -inf minus -inf); objects with no finite pair (fully masked) come
    back with lmap = levid = -inf and a zero PDF.  Shapes must divide.
    Returns (pdfs, lmap, levid) as `Sharded` over objects.
    """
    n = mesh.size
    lnp_of = _lnprob_fn(dim_prior, ignore_model_err)

    def rotate(cur):
        # Shard k - 1's models move to shard k.
        return [tuple(t.to(mesh.devices[k], non_blocking=True)
                      for t in cur[k - 1]) for k in range(n)]

    def f(d, de, dm, m, me, mm, G):
        ds = [_as_sharded(mesh, x, OBJ_AXIS) for x in (d, de, dm)]
        ms = [_as_sharded(mesh, x, OBJ_AXIS) for x in (m, me, mm, G)]
        loc = [tuple(x.shards[k] for x in ds) for k in range(n)]
        cur = [tuple(x.shards[k] for x in ms) for k in range(n)]
        state = []
        for k in range(n):
            d_k, de_k = loc[k][:2]
            m_k, G_k = cur[k][0], cur[k][3]
            dt = torch.promote_types(torch.promote_types(d_k.dtype,
                                                         de_k.dtype),
                                     torch.promote_types(m_k.dtype,
                                                         torch.float32))
            pdt = torch.promote_types(dt, G_k.dtype)
            B, dev = d_k.shape[0], d_k.device
            state.append(dict(
                rm=torch.full((B,), float(np.finfo(np.float32).min),
                              dtype=dt, device=dev),
                s=torch.zeros(B, dtype=dt, device=dev),
                pdf=torch.zeros((B, G_k.shape[1]), dtype=pdt, device=dev)))

        if wt_thresh is None:
            for _ in range(n):
                for k in range(n):
                    st = state[k]
                    lnp = lnp_of(*loc[k], *cur[k][:3])
                    new_m = torch.maximum(st["rm"], lnp.amax(dim=1))
                    alpha = torch.exp(st["rm"] - new_m)
                    w = torch.exp(lnp - new_m[:, None])
                    st["s"] = st["s"] * alpha + w.sum(dim=1)
                    st["pdf"] = st["pdf"] * alpha[:, None] + _kde.fp32_matmul(
                        w, cur[k][3].to(w.dtype))
                    st["rm"] = new_m
                cur = rotate(cur)
            for st in state:
                s, rm = st["s"], st["rm"]
                st["levid"] = torch.log(torch.clamp_min(
                    s, torch.finfo(s.dtype).tiny)) + rm
                st["pdf"] = st["pdf"] * torch.exp(rm - st["levid"])[:, None]
                st["lmap"] = rm
        else:
            for _ in range(n):
                for k in range(n):
                    st = state[k]
                    lnp = lnp_of(*loc[k], *cur[k][:3])
                    new_m = torch.maximum(st["rm"], lnp.amax(dim=1))
                    st["s"] = (st["s"] * torch.exp(st["rm"] - new_m)
                               + torch.exp(lnp - new_m[:, None]).sum(dim=1))
                    st["rm"] = new_m
                cur = rotate(cur)
            log_thr = float(np.log(wt_thresh))
            for st in state:
                s = st["s"]
                st["lmap"] = st["rm"]
                st["levid"] = torch.log(torch.clamp_min(
                    s, torch.finfo(s.dtype).tiny)) + st["lmap"]
            for _ in range(n):
                for k in range(n):
                    st = state[k]
                    lnp = lnp_of(*loc[k], *cur[k][:3])
                    w = torch.exp(lnp - st["levid"][:, None])
                    w = torch.where(lnp > log_thr + st["lmap"][:, None], w,
                                    0.0)
                    st["pdf"] = st["pdf"] + _kde.fp32_matmul(
                        w, cur[k][3].to(w.dtype))
                cur = rotate(cur)

        parts = []
        for st in state:
            # The finite seed survives where no pair was finite: report
            # -inf, as the replicated-model paths do.
            dead = st["s"] <= 0
            lmap = torch.where(dead, -torch.inf, st["lmap"])
            levid = torch.where(dead, -torch.inf, st["levid"])
            parts.append((_kde.norm_rows(st["pdf"]), lmap, levid))
        return _collect(mesh, parts, OBJ_AXIS, ds[0].global_shape[0])

    return f


def stacked_nz(mesh, pdfs):
    """Stacked N(z) over all objects: the shards' sums added in shard
    order on the first shard's device, then, when a `torch.distributed`
    group is initialized, one ``all_reduce(SUM)`` across its processes.  `pdfs` is a `Sharded` over
    objects (host arrays and tensors are split first)."""
    pdfs = _as_sharded(mesh, pdfs, OBJ_AXIS)
    blocks = pdfs.blocks()
    home = blocks[0].device
    total = None
    for b in blocks:
        s = b.sum(dim=0).to(home)
        total = s if total is None else total + s
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return total
