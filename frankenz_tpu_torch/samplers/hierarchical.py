"""
Hierarchical N(z) sampler: collapsed Gibbs with a Dirichlet hyper-prior
(port of `frankenz_tpu.samplers.hierarchical`).

Model: per-object redshift-bin assignments z_g ~ Categorical(p_g * rho),
population rho ~ Dirichlet(alpha + counts [+ ref_counts]), and an optional
unrepresentative-reference-sample step.  Inputs must be *likelihoods* (the
prior is modeled explicitly).

Each Gibbs sweep is vectorized in plain torch on the sampler's device: one
Gumbel-max categorical over the (Nobs, Nbins) weight matrix, the bin
counts, the Dirichlet and multinomial draws and the closed-form
log-pmf/pdf evaluations; `nchains` is a batch dimension.  There is no
hand-written kernel here, as the JAX package has none: a sweep's cost is
the categorical draw over every object, not a chain of small steps.  Every
draw takes the run's explicit `torch.Generator`.

Under ``mesh=`` (a `parallel.Mesh`) the PDF rows split over the mesh's
devices, padded to a multiple of ``mesh.size`` with uniform rows that the
counts leave out, and the chain state lives on the mesh's first device.
Each shard draws its objects' categories on its device and counts them
(`bincount`); the counts are summed in shard order.  Shard 0 draws from
the run's generator and shard k > 0 from its own, seeded from the run's
seed and k, so a one-shard mesh gives the single-device chain bit for
bit.  (JAX folds the shard index into its draw key instead, so its mesh
chain differs from its single-device chain too.)
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..parallel import mesh as _mesh
from ..utils.progress import train_note
from .base import ChainSampler

__all__ = ["hierarchical_sampler", "multinomial_logpmf", "dirichlet_logpdf"]


def multinomial_logpmf(counts, n, p):
    """Closed-form multinomial log-pmf (scipy's convention: the support
    requires sum(counts) == n; zero probabilities with zero counts
    contribute 0 via xlogy).  Keeps the dtype of `counts`."""
    counts = torch.as_tensor(counts)
    n = torch.as_tensor(n, dtype=counts.dtype, device=counts.device)
    p = torch.as_tensor(p, dtype=counts.dtype, device=counts.device)
    return (torch.lgamma(n + 1.0) - torch.lgamma(counts + 1.0).sum(dim=-1)
            + torch.xlogy(counts, p).sum(dim=-1))


def dirichlet_logpdf(x, alpha):
    """Closed-form Dirichlet log-pdf.  Keeps the dtype of `x`."""
    x = torch.as_tensor(x)
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    return (torch.lgamma(alpha.sum(dim=-1)) - torch.lgamma(alpha).sum(dim=-1)
            + torch.xlogy(alpha - 1.0, x).sum(dim=-1))


def _bin_counts(idx, nbins, dtype):
    """Per-chain counts of the (nchains, N) bin indices.  Each entry adds
    1.0, so the float result is exact in any order below 2^24."""
    nchains = idx.shape[0]
    offs = torch.arange(nchains, device=idx.device)[:, None] * nbins
    return torch.bincount((idx + offs).reshape(-1),
                          minlength=nchains * nbins).reshape(
                              nchains, nbins).to(dtype)


def _shard_generator(seed, k, device):
    """Shard k's (> 0) generator of the category draws under a mesh,
    seeded with 63 bits of ``numpy.random.SeedSequence([seed, k])``."""
    state = np.random.SeedSequence([int(seed), int(k)]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state) >> 1)
    return gen


def _hier_run(gen, pos, log_pdfs, alpha, beta, ref, ref_norm, ref_counts, *,
              nref, nobs, niter, thin, has_ref, zgens=None, nvalid=None):
    """`niter` thinned samples of every chain, `thin` sweeps each.

    pos, ref_counts: (nchains, Nbins), the Gibbs carry; log_pdfs:
    (Nobs, Nbins), hoisted (only the log of the population vector changes
    per sweep), or a list of object shards, each on its device, drawn
    with `zgens` (one generator a shard) and counted over its first
    `nvalid` rows.  Returns (samples (nchains, niter, Nbins), lnps
    (nchains, niter), ref_counts): the final carry lets block-streaming
    callers resume exactly.
    """
    if not isinstance(log_pdfs, list):
        log_pdfs, zgens, nvalid = [log_pdfs], [gen], [log_pdfs.shape[0]]
    nchains, nbins = pos.shape
    samples = pos.new_empty((nchains, niter, nbins))
    lnps = pos.new_empty((nchains, niter))
    lnp = pos.new_zeros(nchains)
    for it in range(niter):
        for _ in range(thin):
            # Per-object categorical draw ~ p_g * rho via Gumbel-max,
            # shard by shard; the counts add in shard order.
            logpos = torch.log(pos)
            counts = None
            for lp, zgen, nv in zip(log_pdfs, zgens, nvalid):
                logits = lp[None] + logpos.to(lp.device)[:, None, :]
                g = -torch.log(torch.empty_like(logits).exponential_(
                    generator=zgen))
                zdraw = torch.argmax(logits + g, dim=2)
                c = _bin_counts(zdraw[:, :nv], nbins, pos.dtype).to(
                    pos.device)
                counts = c if counts is None else counts + c
            # Population draw.
            gam = torch._standard_gamma(alpha + counts + ref_counts,
                                        generator=gen)
            pos = gam / gam.sum(dim=1, keepdim=True)
            # Reference-sample draw.
            if has_ref:
                pcounts = ref + beta + nobs * pos
                draws = torch.multinomial(
                    pcounts / pcounts.sum(dim=1, keepdim=True), nref,
                    replacement=True, generator=gen)
                ref_counts = _bin_counts(draws, nbins, pos.dtype)
                lnpriorref = multinomial_logpmf(ref_counts, float(nref),
                                                ref_norm)
            else:
                lnpriorref = 0.0
            lnlike = multinomial_logpmf(counts, float(nobs), pos)
            lnprior = dirichlet_logpdf(pos, alpha + ref_counts)
            lnp = lnlike + lnprior + lnpriorref
        samples[:, it] = pos
        lnps[:, it] = lnp
    return samples, lnps, ref_counts


class hierarchical_sampler(ChainSampler):
    """Collapsed Gibbs sampler over (z_g, rho), with `nchains` parallel
    chains (see `population_sampler` for the results layout)."""

    def _resolve_hyper(self, alpha, beta, ref_sample):
        """Flat alpha/beta defaults + reference-sample normalization."""
        nbins = self.pdfs.shape[1]
        alpha = (np.ones(nbins) if alpha is None
                 else np.asarray(alpha, float))
        beta = np.ones(nbins) if beta is None else np.asarray(beta, float)
        has_ref = ref_sample is not None
        if has_ref:
            ref_sample = np.asarray(ref_sample, float)
            ref_norm = ref_sample + beta
            ref_norm = ref_norm / ref_norm.sum()
            nref = float(ref_sample.sum())
        else:
            ref_sample = np.zeros(nbins)
            ref_norm = np.ones(nbins) / nbins
            nref = 0.0
        return alpha, beta, ref_sample, ref_norm, nref, has_ref

    def _make_runner(self, mesh, hyper, thin, seed):
        """`run(niter, pos, ref0) -> (samples, lnps, ref_final)` closure
        with the log-PDF matrix (split over `mesh`'s devices when given)
        and hyper arrays staged once, and the run's generator seeded from
        `seed`."""
        alpha, beta, ref_sample, ref_norm, nref, has_ref = hyper
        nobs, nbins = self.pdfs.shape
        home, zgens, nvalid = self.device, None, None
        if mesh is None:
            if getattr(self, "_log_pdfs_dev", None) is None:
                self._log_pdfs_dev = torch.log(self._tensor(self.pdfs))
            log_pdfs = self._log_pdfs_dev
        else:
            _mesh.check_mesh(mesh)
            home = mesh.devices[0]
            pad = np.full(((-nobs) % mesh.size, nbins), 1.0 / nbins)
            per = (nobs + len(pad)) // mesh.size
            logs = torch.log(self._tensor(np.concatenate([self.pdfs, pad])))
            log_pdfs = [logs[k * per:(k + 1) * per].to(dev)
                        for k, dev in enumerate(mesh.devices)]
            nvalid = [min(per, max(nobs - k * per, 0))
                      for k in range(mesh.size)]
        alpha_t, beta_t, ref_t, ref_norm_t = (
            self._tensor(x).to(home)
            for x in (alpha, beta, ref_sample, ref_norm))
        gen = torch.Generator(device=home)
        gen.manual_seed(seed)
        if mesh is not None:
            zgens = [gen] + [_shard_generator(seed, k, dev) for k, dev in
                             enumerate(mesh.devices) if k > 0]

        def run(niter, pos, ref0):
            pos = self._tensor(pos).to(home)
            if ref0 is None:
                ref0 = ref_t.expand_as(pos).clone()
            return _hier_run(gen, pos, log_pdfs, alpha_t, beta_t, ref_t,
                             ref_norm_t, ref0, nref=int(round(nref)),
                             nobs=nobs, niter=niter, thin=int(thin),
                             has_ref=has_ref, zgens=zgens, nvalid=nvalid)

        return run

    def run_mcmc(self, Niter, alpha=None, pos_init=None, thin=5,
                 ref_sample=None, beta=None, rng=None, seed=None,
                 verbose=True, nchains=1, mesh=None):
        """Draw `Niter` (thinned) samples and append them to the stored
        chain: flat alpha/beta defaults, resume from the last stored
        sample, default init = stacked PDFs.  `mesh` (a `parallel.Mesh`)
        splits the objects over its devices (see the module docstring)."""
        t0 = time.time()
        hyper = self._resolve_hyper(alpha, beta, ref_sample)
        pos0 = self._resolve_pos0(pos_init, nchains)
        run = self._make_runner(mesh, hyper, thin,
                                self._resolve_seed(seed, rng))
        samples, lnps, _ = run(Niter, pos0, None)
        self._store_run(samples.cpu().numpy().astype(float),
                        lnps.cpu().numpy().astype(float), nchains, Niter)
        train_note(verbose, "hierarchical MCMC", Niter, t0)
        return self

    def sample(self, Niter, alpha=None, pos_init=None, thin=5,
               ref_sample=None, beta=None, rng=None, seed=None,
               verbose=True, nchains=1, mesh=None, block=1):
        """Generator yielding one `(pos, lnpost)` per (thinned) sample, AS
        THE CHAIN RUNS: the chain advances `block` thinned samples per
        call, resuming each block from the previous block's full Gibbs
        carry (position AND reference counts) and the run's one
        generator, so the first yield costs O(block * thin) sweeps and a
        seeded stream equals `run_mcmc`'s.  This does NOT append to the
        stored chain; only `run_mcmc` does.
        """
        del verbose
        hyper = self._resolve_hyper(alpha, beta, ref_sample)
        pos = self._resolve_pos0(pos_init, nchains)
        run = self._make_runner(mesh, hyper, thin,
                                self._resolve_seed(seed, rng))
        ref0 = None
        for i0 in range(0, Niter, block):
            nb = min(block, Niter - i0)
            samples, lnps, ref0 = run(nb, pos, ref0)
            pos = samples[:, -1, :]
            samples = samples.cpu().numpy().astype(float)
            lnps = lnps.cpu().numpy().astype(float)
            for it in range(nb):
                if nchains == 1:
                    yield samples[0, it], float(lnps[0, it])
                else:
                    yield samples[:, it, :], lnps[:, it]
