"""The port's multi-process path: `launch_local_cluster(2, 4)` over gloo
(each worker loads its block, runs the sharded step on a 4-shard CPU mesh
and reduces the stacked N(z) across processes, held against the
single-device plain route), `initialize_distributed` and its refusals,
and the rule that the port's `parallel` package, and its workers, load
no JAX.

Nothing here imports JAX.  Each cluster has its own free port and a
timeout of its own: a worker that hangs fails its test.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from frankenz_tpu_torch import parallel as PL
from frankenz_tpu_torch.parallel import distributed as PD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_jax_path(tmp_path, monkeypatch):
    """A PYTHONPATH on which `import jax` fails, for child processes."""
    fake = tmp_path / "jax"
    fake.mkdir()
    (fake / "__init__.py").write_text(
        "raise ImportError('the PyTorch port must not import jax')\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), REPO, os.environ.get("PYTHONPATH", "")]))


def test_two_process_cluster_over_gloo(no_jax_path):
    outs = PL.launch_local_cluster(num_processes=2, local_devices=4,
                                   timeout=240)
    assert len(outs) == 2
    for pid, out in enumerate(outs):
        assert f"[proc {pid}/2] multi-process parity OK" in out, out[-500:]
        assert "global=8" in out


def test_parallel_import_loads_no_jax():
    code = ("import sys; import frankenz_tpu_torch.parallel, "
            "frankenz_tpu_torch.parallel.distributed; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'frankenz_tpu.'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_initialize_distributed_refusals(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        PL.initialize_distributed("127.0.0.1:1", backend="gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl"):
        PL.initialize_distributed("127.0.0.1:1", 1, 0, backend="nccl")
    assert not torch.distributed.is_initialized()


def test_one_process_group_stacked_nz():
    """A gloo group of one process: `stacked_nz` goes through its
    all-reduce and returns the plain sum; the group is left after."""
    port = PD._free_port()
    rank, world = PL.initialize_distributed(f"127.0.0.1:{port}", 1, 0,
                                            backend="gloo", timeout=60)
    try:
        assert (rank, world) == (0, 1)
        assert PL.initialize_distributed() == (0, 1)  # idempotent
        mesh = PL.make_mesh(devices=["cpu"] * 4)
        rng = np.random.default_rng(3)
        pdfs = rng.uniform(size=(64, 33))
        nz = PL.stacked_nz(mesh, PL.shard_objects(mesh, pdfs))
        np.testing.assert_allclose(nz.numpy(), pdfs.sum(axis=0),
                                   rtol=1e-12)
    finally:
        PL.shutdown_distributed()
    assert not torch.distributed.is_initialized()
