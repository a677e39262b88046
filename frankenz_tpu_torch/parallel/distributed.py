"""
Multi-process runtime: `torch.distributed` initialization and a local
cluster that checks the multi-process path (port of
`frankenz_tpu.parallel.distributed`).

Each process drives its own devices through its own `Mesh`; the processes
form one `torch.distributed` group (NCCL between cards, gloo between CPU
processes), the catalog enters through `io.catalog_from_process_shards`
(each process loads only its contiguous object block) and `mesh.stacked_nz`
adds the processes' partial sums with one all-reduce.

`launch_local_cluster` runs that path with real processes: fresh Python
workers on the CPU, a gloo group over localhost, and in each worker the
local block -> `catalog_from_process_shards` -> `sharded_fit_predict_step`
-> `stacked_nz` across processes, held against the single-device plain
route.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time

import torch

__all__ = ["initialize_distributed", "shutdown_distributed",
           "launch_local_cluster"]

DEFAULT_TIMEOUT = 120.0


def _address(coordinator_address):
    """'host:port' (or 'tcp://host:port') -> 'tcp://host:port'; None reads
    MASTER_ADDR / MASTER_PORT (as torchrun sets them)."""
    if coordinator_address is None:
        host, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if not host or not port:
            raise ValueError("initialize_distributed: give "
                             "coordinator_address='host:port' or set "
                             "MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{host}:{port}"
    if not coordinator_address.startswith("tcp://"):
        coordinator_address = "tcp://" + coordinator_address
    return coordinator_address


def _env_int(value, name):
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise ValueError(f"initialize_distributed: give the argument or "
                         f"set {name}")
    return int(os.environ[name])


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None,
                           timeout=DEFAULT_TIMEOUT):
    """Join this process to a `torch.distributed` group over ``tcp://``.

    Arguments not given are read from torchrun's environment
    (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK).  `backend` defaults to
    ``"nccl"`` when a card is available and ``"gloo"`` otherwise; asking
    for NCCL without a card raises (there is no switch to gloo).  The
    group's operations, and the rendezvous, raise after `timeout` seconds
    instead of hanging.  Returns ``(rank, world_size)``; a second call
    returns the existing group's.
    """
    dist = torch.distributed
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and not (torch.cuda.is_available()
                                  and dist.is_nccl_available()):
        raise RuntimeError("initialize_distributed(backend='nccl') needs a "
                           "CUDA device and NCCL; for CPU processes pass "
                           "backend='gloo'")
    world = _env_int(num_processes, "WORLD_SIZE")
    rank = _env_int(process_id, "RANK")
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=_address(coordinator_address),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=float(timeout)))
    return dist.get_rank(), dist.get_world_size()


def shutdown_distributed():
    """Leave the group (`destroy_process_group`), if one is initialized."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _problem(nobj, nmodel, ngrid):
    """The cluster's deterministic catalog, models and kernel matrix
    (the JAX harness's draws), as float32 host arrays."""
    import numpy as np

    from ..ops import kde as _kde

    rng = np.random.default_rng(0)
    m = rng.uniform(1, 10, (nmodel, 5)).astype(np.float32)
    me = (0.05 * m).astype(np.float32)
    mm = np.ones_like(m)
    d = (m[rng.integers(0, nmodel, nobj)]
         + rng.normal(0, 0.3, (nobj, 5))).astype(np.float32)
    de = np.full((nobj, 5), 0.3, np.float32)
    dm = np.ones_like(d)
    G = _kde.kernel_matrix(rng.uniform(0, 3, nmodel),
                           np.full(nmodel, 0.1), np.linspace(0, 3, ngrid),
                           device="cpu").numpy().astype(np.float32)
    return d, de, dm, m, me, mm, G


def _worker_body(coordinator, num_processes, process_id, nobj, nmodel,
                 ngrid, local_devices=4, timeout=DEFAULT_TIMEOUT):
    """One worker of `launch_local_cluster` (a fresh process): its block
    through the sharded step, N(z) across processes, each held against
    the single-device plain route on the whole catalog.  A mismatch
    raises, so the process exits nonzero."""
    import numpy as np

    from ..ops import kde as _kde
    from ..ops import likelihood as _like
    from .io import catalog_from_process_shards, process_shard_bounds
    from .mesh import make_mesh, replicate, sharded_fit_predict_step, \
        stacked_nz

    torch.set_num_threads(1)
    initialize_distributed(coordinator, num_processes, process_id,
                           backend="gloo", timeout=timeout)
    try:
        if torch.distributed.get_world_size() != num_processes:
            raise AssertionError(torch.distributed.get_world_size())
        d, de, dm, m, me, mm, G = _problem(nobj, nmodel, ngrid)

        # This process loads only its block; the global arrays span the
        # processes.
        start, stop = process_shard_bounds(nobj)
        mesh = make_mesh(devices=["cpu"] * local_devices)
        dG, deG, dmG = catalog_from_process_shards(
            mesh, (d[start:stop], de[start:stop], dm[start:stop]), nobj)
        if dG.is_fully_addressable:
            raise AssertionError("the catalog did not cross processes")
        step = sharded_fit_predict_step(mesh)
        pdfs, lmap, levid = step(dG, deG, dmG,
                                 *replicate(mesh, m, me, mm, G))
        nz = stacked_nz(mesh, pdfs)

        # The single-device plain route on the whole catalog.
        t = [torch.as_tensor(a) for a in (d, de, dm, m, me, mm)]
        lnp = _like.logprob(*t).lnprob
        lv = torch.logsumexp(lnp, dim=1)
        lm = lnp.amax(dim=1)
        ref = _kde.norm_rows(_kde.kde_stack(
            torch.exp(lnp - lv[:, None]), torch.as_tensor(G), 1e-3, None))

        for arr, want in ((pdfs, ref), (lmap, lm), (levid, lv)):
            for k, shard in enumerate(arr.shards):
                np.testing.assert_allclose(
                    shard.numpy(), want[arr.global_rows(k)].numpy(),
                    rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(nz.numpy(), ref.sum(dim=0).numpy(),
                                   rtol=1e-5, atol=1e-6)
        print(f"[proc {process_id}/{num_processes}] multi-process parity "
              f"OK (devices local={mesh.size} "
              f"global={mesh.size * num_processes}, rows {start}:{stop})",
              flush=True)
    finally:
        shutdown_distributed()


def launch_local_cluster(num_processes=2, local_devices=4, nobj=64,
                         nmodel=96, ngrid=65, timeout=300):
    """Run the multi-process check on a local CPU cluster.

    Spawns `num_processes` fresh Python workers, each with a mesh of
    `local_devices` shards on the CPU, in one gloo group over a free
    localhost port; every worker runs `_worker_body` and must exit 0
    within `timeout` seconds (all of them together), else every worker
    is killed and RuntimeError raised.  Returns the workers' outputs.
    """
    coordinator = f"127.0.0.1:{_free_port()}"
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    code = ("import sys; sys.path.insert(0, {repo!r})\n"
            "from frankenz_tpu_torch.parallel.distributed import "
            "_worker_body\n"
            "_worker_body({coord!r}, {np_}, {pid}, {nobj}, {nmodel}, "
            "{ngrid}, {ndev}, {tmo})\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         code.format(repo=repo, coord=coordinator, np_=num_processes,
                     pid=pid, nobj=nobj, nmodel=nmodel, ngrid=ngrid,
                     ndev=local_devices, tmo=float(timeout))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(num_processes)]
    deadline = time.monotonic() + timeout
    outs, fail = [], None
    try:
        for pid, p in enumerate(procs):
            try:
                out, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                fail = fail or f"worker {pid} timed out after {timeout} s"
                break
            outs.append(out)
            if p.returncode != 0 and fail is None:
                fail = (f"worker {pid} rc={p.returncode}\n"
                        f"--- worker {pid} output ---\n{out[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if fail:
        raise RuntimeError(f"local cluster failed: {fail}")
    return outs
