"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made from a seed with NumPy and handed to both packages; the
JAX side runs on the CPU as the JAX suite runs it (Pallas kernels in
interpret mode), the port on CPU tensors (its kernels' plain versions).
"""

import numpy as np
import torch

from frankenz_tpu.ops import kde as JK

# The suite runs several xdist workers per machine: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def to_numpy(x):
    """Tensor / JAX array / NumPy -> NumPy (recursing into tuples)."""
    if isinstance(x, (tuple, list)):
        return tuple(to_numpy(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def run_both(jax_fn, torch_fn, *inputs, jax_kw=None, torch_kw=None, **kw):
    """Feed the same NumPy inputs through the JAX function and its port;
    returns (jax_out, torch_out) as NumPy (tuples kept)."""
    want = jax_fn(*inputs, **kw, **(jax_kw or {}))
    got = torch_fn(*inputs, **kw, **(torch_kw or {}))
    return to_numpy(want), to_numpy(got)


def fullmask_problem(F, B=19, M=251, Ngrid=77, seed=23, outlier_row=True):
    """Full-mask photometry at the shapes of tests/test_fused.py, ragged
    in B, M and Ngrid; row 0 optionally an insane outlier whose every
    chi^2 exceeds the 3e4 clamp."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(1, 10, (M, F)).astype(np.float32)
    me = (0.05 * m).astype(np.float32)
    mm = np.ones((M, F), np.float32)
    d = (m[rng.integers(0, M, B)]
         + rng.normal(0, 0.3, (B, F))).astype(np.float32)
    if outlier_row:
        d[0] = 1e6
    de = np.full((B, F), 0.3, np.float32)
    dm = np.ones((B, F), np.float32)
    G = np.asarray(JK.kernel_matrix(
        rng.uniform(0, 3, M), np.full(M, 0.1), np.linspace(0, 3, Ngrid)),
        np.float32)
    return d, de, dm, m, me, mm, G
