"""Shared chain-store machinery for the MCMC samplers (port of
`frankenz_tpu.samplers.base`).

Both samplers keep their chains as Python lists on `self` and resume from
the last stored sample; this base class holds that state, the
multi-chain results views, and the position and seed resolution shared by
`run_mcmc` and the streaming `sample` generators.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ChainSampler"]


class ChainSampler:
    """Chain storage + init/resume resolution common to both samplers.

    The chains run on `device` in `dtype`; ``device="cuda"`` without a
    card raises: nothing falls back to the CPU.  The host copy `pdfs`
    stays float64 NumPy, and every result is a NumPy array.
    """

    def __init__(self, pdfs, device="cuda", dtype=torch.float32):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("{}(device='cuda') needs a CUDA device; none "
                               "is available".format(type(self).__name__))
        self.dtype = dtype
        # Host-side float64: mixed-precision inputs (e.g. float32 PDFs
        # from the fitters) convert once, to the sampler's dtype, when
        # they are staged on the device.
        self.pdfs = np.asarray(pdfs, float)
        self.samples = []
        self.samples_lnp = []
        self._chain_state = None

    def reset(self):
        """Re-initialize the sampler."""
        self.samples = []
        self.samples_lnp = []
        self._chain_state = None

    @property
    def results(self):
        """(samples, lnpost) arrays; multi-chain samples interleaved."""
        s = np.array(self.samples)
        lnp = np.array(self.samples_lnp)
        if s.ndim == 3:  # (Niter, nchains, Nbins) -> interleaved
            s = s.reshape(-1, s.shape[-1])
            lnp = lnp.reshape(-1)
        return s, lnp

    @property
    def results_by_chain(self):
        """(Niter, nchains, Nbins) samples + (Niter, nchains) lnpost."""
        s = np.array(self.samples)
        lnp = np.array(self.samples_lnp)
        if s.ndim == 2:
            s = s[:, None, :]
            lnp = lnp[:, None]
        return s, lnp

    def _resolve_pos0(self, pos_init, nchains):
        """Initial per-chain positions: explicit init, else the resumed
        chain state, else the stacked-PDF default."""
        if pos_init is None:
            if self._chain_state is not None:
                pos0 = self._chain_state
            elif self.samples:
                pos0 = np.atleast_2d(np.asarray(self.samples[-1]))
            else:
                stack = self.pdfs.sum(axis=0) / self.pdfs.sum()
                pos0 = np.tile(stack, (nchains, 1))
        else:
            pos0 = np.atleast_2d(np.asarray(pos_init, float))
        if pos0.shape[0] != nchains:
            pos0 = np.tile(pos0[0], (nchains, 1))
        return pos0

    @staticmethod
    def _resolve_seed(seed, rng):
        """One integer seed: `seed`, else a draw from `rng`, else fresh
        entropy.  Every draw of a run comes from an explicit
        `torch.Generator` seeded from it; no global RNG state is used."""
        return int(seed if seed is not None
                   else (rng.integers(2**31) if rng is not None
                         else np.random.default_rng().integers(2**31)))

    def _tensor(self, x):
        """`x` on the sampler's device in its dtype."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device=self.device, dtype=self.dtype)

    def _store_run(self, samples, lnps, nchains, Niter):
        """Append a finished (nchains, Niter, ...) run to the chain."""
        for it in range(Niter):
            if nchains == 1:
                self.samples.append(samples[0, it])
                self.samples_lnp.append(float(lnps[0, it]))
            else:
                self.samples.append(samples[:, it, :])
                self.samples_lnp.append(lnps[:, it])
        self._chain_state = samples[:, -1, :]
