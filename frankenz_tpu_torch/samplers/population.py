"""
Population N(z) sampler: MH-in-Gibbs over the simplex of bin heights
(port of `frankenz_tpu.samplers.population`).

Model: given per-object redshift PDFs p_g on a common grid, the
population distribution rho maximizes ``sum_g ln(p_g . rho)``.  Proposals
move along random (+1, -1) pair basis vectors of the simplex with a step
scale set by a numerical gradient, and are accepted via
``-Exponential() < delta ln(post)``.  The overlap vector (Nobs,) is carried
and rank-1-updated per proposal, so each proposal costs O(Nobs), and
`nchains` independent chains run side by side.

Two routes, as in the JAX package:

* the kernel route, under the flat prior: the whole run is one launch of
  `kernels.pop.pop_chain` (one thread block per chain on the card; its
  plain version on the CPU).  It follows the Pallas kernel
  (frankenz_tpu/samplers/population.py:179): log-sums floored at 1e-30, a
  move to a negative bin scored -3.0e38, float32;
* the general route, for any `logprior_nz`: a step loop in torch on the
  sampler's device and dtype, the counterpart of the JAX scan
  (`_chain_step`, population.py:374): plain sums of log(ov), a move to a
  negative bin scored -inf, the prior's difference added to the gradient.

Both routes consume one table of draws per chain (`_pop_draws`), one row
per Gibbs step, and carry (position, overlap, lnpost) across blocks, so a
seeded `sample` streams the chain that `run_mcmc` stores.  Neither
recomputes ``pdfs @ pos`` along the way.

Under ``mesh=`` (a `parallel.Mesh`) the general route runs with the PDF
rows split over the mesh's devices and the chain state on its first
device: each overlap lives with its rows, and every log-likelihood sum is
the shards' partial sums added in shard order.  The objects pad to a
multiple of ``mesh.size`` with uniform rows, whose constant term in
lnpost (pair moves keep sum(pos)) is taken off the stored values, as in
JAX.  The kernel route never runs under a mesh (JAX's rule,
frankenz_tpu/samplers/population.py:655).

`logprior_nz`, if given, takes a torch tensor: ``logprior_nz(pos,
*prior_args, **prior_kwargs) -> scalar``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..kernels import pop as _kpop
from ..kernels.pop import _log1p_f32, _pair_dlnl_terms  # noqa: F401
from ..parallel import mesh as _mesh
from ..utils.progress import train_note
from .base import ChainSampler

__all__ = ["loglike_nz", "population_sampler"]


def loglike_nz(nz, pdfs, overlap=None, return_overlap=False, pair=None,
               pair_step=None):
    """Log-likelihood of a population distribution given per-object PDFs,
    with the rank-1 pair perturbation and the -inf guard for invalid
    (negative / non-finite) positions.  Keeps the dtype of its input."""
    nz = torch.as_tensor(nz)
    pdfs = torch.as_tensor(pdfs, device=nz.device)
    dtype = torch.promote_types(nz.dtype, pdfs.dtype)
    nz, pdfs = nz.to(dtype), pdfs.to(dtype)
    bad = (~torch.isfinite(nz) | (nz < 0.0)).any()
    if overlap is None:
        overlap = pdfs @ nz
    ov = torch.as_tensor(overlap, dtype=dtype, device=nz.device)
    if pair is not None and pair_step is not None:
        i, j = pair
        ov = ov + pair_step * (pdfs[:, i] - pdfs[:, j])
    lnlike = torch.where(bad, -torch.inf, torch.log(ov).sum())
    ov = torch.where(bad, 0.0, ov)
    if return_overlap:
        return lnlike, ov
    return lnlike


def _zero_prior(pos, *args, **kwargs):
    """Default flat prior."""
    return 0.0


def _chain_generator(seed, chain):
    """The CPU generator of one chain's draws, seeded with 63 bits of
    ``numpy.random.SeedSequence([seed, chain])``."""
    state = np.random.SeedSequence([int(seed), int(chain)]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(state) >> 1)
    return gen


def _pop_draws(gen, nsteps, nbins, mh_steps):
    """All of one chain's randomness, precomputed: per Gibbs step an
    unordered pair (i, then j != i uniform over the rest), `mh_steps`
    standard normals and `mh_steps` unit exponentials, as one
    (nsteps, 2 + 2 * mh_steps) float32 table on the CPU.

    `gen` is a CPU `torch.Generator`; the samplers derive chain c's from
    `_chain_generator(seed, c)`, so a seeded run takes the same table on
    the CPU and on the card.
    """
    i = torch.randint(0, nbins, (nsteps,), generator=gen)
    j = torch.randint(0, nbins - 1, (nsteps,), generator=gen)
    j = j + (j >= i).to(j.dtype)
    z = torch.randn((nsteps, mh_steps), generator=gen, dtype=torch.float32)
    e = torch.empty((nsteps, mh_steps), dtype=torch.float32).exponential_(
        generator=gen)
    return torch.cat([i[:, None].to(torch.float32),
                      j[:, None].to(torch.float32), z, e], dim=1)


def _prior_values(prior, pos):
    """`prior` of every chain's position, (nchains,) in pos's dtype."""
    if prior is _zero_prior:
        return pos.new_zeros(pos.shape[0])
    return torch.stack([torch.as_tensor(prior(p), dtype=pos.dtype,
                                        device=pos.device).reshape(())
                        for p in pos])


def _shard_sum(parts, device):
    """Per-shard partial sums added in shard order on `device` (one part
    comes back as it is)."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def _pop_run(draws, pdfsT, pos, ov, lnp, *, prior, thin, mh_steps):
    """The general route: T Gibbs steps of every chain as a step loop in
    torch, one row of `draws` (nchains, T, 2 + 2 * mh_steps) per step.

    `pdfsT` (Nbins, Nobs) and `ov` (nchains, Nobs) may be lists, the
    object shards of a mesh, each on its device: then each likelihood sum
    is the shards' partial sums added in shard order on pos's device (one
    shard is the single-device loop, bit for bit).  Returns (samples
    (nchains, T / thin, Nbins), lnps (nchains, T / thin), pos, ov, lnp);
    the final (pos, ov, lnp) is the exact MH carry, so block-streaming
    callers resume as one uninterrupted run.
    """
    sharded = isinstance(pdfsT, list)
    if not sharded:
        pdfsT, ov = [pdfsT], [ov]
    nchains, T, _ = draws.shape
    nbins = pdfsT[0].shape[0]
    dev = pos.device
    c = _kpop.consts(pos.dtype, dev)
    samples = pos.new_empty((nchains, T // thin, nbins))
    lnps = pos.new_empty((nchains, T // thin))
    bins = torch.arange(nbins, device=dev)
    for s in range(T):
        row = draws[:, s]
        i = row[:, 0].long()
        j = row[:, 1].long()
        dcol = [P[i.to(P.device)] - P[j.to(P.device)] for P in pdfsT]
        t = ((bins == i[:, None]).to(pos.dtype)
             - (bins == j[:, None]).to(pos.dtype))
        pi = pos.gather(1, i[:, None])[:, 0]
        pj = pos.gather(1, j[:, None])[:, 0]
        # Numerical gradient along the pair direction, through the
        # cancellation-free ratio form (`_pair_dlnl_terms`).
        scale = c["step"] * torch.minimum(
            torch.minimum(pi, pj),
            torch.minimum(c["one"] - pi, c["one"] - pj))
        hs = (scale / c["two"])[:, None]
        dlnl = _shard_sum([_pair_dlnl_terms(o, hs.to(o.device) * d).sum(
            dim=1) for o, d in zip(ov, dcol)], dev)
        grad = (dlnl + _prior_values(prior, pos + t * hs)
                - _prior_values(prior, pos - t * hs)) / scale
        gscale = torch.where(
            grad != c["zero"],
            torch.minimum(torch.abs(c["one"] / grad),
                          torch.abs(scale * c["cap"])),
            torch.abs(scale))
        for k in range(mh_steps):
            z = (row[:, 2 + k] * gscale)[:, None]
            e = row[:, 2 + mh_steps + k]
            pos_n = pos + t * z
            ov_n = [o + z.to(o.device) * d for o, d in zip(ov, dcol)]
            bad = (pos_n < c["zero"]).any(dim=1)
            lnp_n = torch.where(
                bad, -torch.inf,
                _shard_sum([torch.log(o).sum(dim=1) for o in ov_n], dev)
                + _prior_values(prior, pos_n))
            accept = -e < (lnp_n - lnp)
            pos = torch.where(accept[:, None], pos_n, pos)
            ov = [torch.where(accept.to(o.device)[:, None], on, o)
                  for o, on in zip(ov, ov_n)]
            lnp = torch.where(accept, lnp_n, lnp)
        if s % thin == thin - 1:
            samples[:, s // thin] = pos
            lnps[:, s // thin] = lnp
    return samples, lnps, pos, (ov if sharded else ov[0]), lnp


class population_sampler(ChainSampler):
    """MH-in-Gibbs sampler over N(z) bin heights.

    `nchains` parallel chains (results interleave chains: sample s of
    chain c is row s*nchains+c of `results`; use `results_by_chain` for
    the (Niter, nchains, Nbins) view).
    """

    def _resolve_prior(self, logprior_nz, prior_args, prior_kwargs):
        prior_kwargs = prior_kwargs or {}
        if logprior_nz is None:
            return _zero_prior
        if prior_args or prior_kwargs:
            return lambda pos: logprior_nz(pos, *prior_args, **prior_kwargs)
        return logprior_nz

    def _kernel_reason(self, prior, nbins, mh_steps):
        """Why this configuration cannot take the kernel route, or None:
        the kernel runs the flat prior in float32 (a prior would have to
        be compiled into it), within its own limits."""
        if prior is not _zero_prior:
            return "the kernel route runs the flat prior only"
        if self.dtype != torch.float32:
            return f"the kernel route is float32, the sampler {self.dtype}"
        return _kpop.limits_reason(int(nbins), self.pdfs.shape[0],
                                   int(mh_steps))

    def _kernel_ok(self, prior, nbins, mh_steps):
        return self._kernel_reason(prior, nbins, mh_steps) is None

    def _pick_route(self, use_kernel, prior, nbins, mh_steps, mesh):
        if mesh is not None:
            _mesh.check_mesh(mesh)
            if use_kernel:
                raise ValueError("use_kernel=True: the kernel route does "
                                 "not run under mesh=")
            return False
        reason = self._kernel_reason(prior, nbins, mh_steps)
        if use_kernel and reason is not None:
            raise ValueError(f"use_kernel=True: {reason}")
        return reason is None if use_kernel is None else bool(use_kernel)

    def _pdfsT(self):
        """The (Nbins, Nobs) transposed PDFs, staged once per sampler."""
        if getattr(self, "_pdfsT_dev", None) is None:
            self._pdfsT_dev = self._tensor(self.pdfs.T)
        return self._pdfsT_dev

    def _tables(self, seed, nchains, nsteps_total, nbins, mh_steps):
        """Every chain's draw table over the whole run, (nchains,
        nsteps_total, 2 + 2 * mh_steps) on the sampler's device: chain c's
        comes from `_chain_generator(seed, c)`.  Cached, so a streamed run
        draws each table once."""
        key = (seed, nchains, int(nsteps_total), int(nbins), int(mh_steps))
        if getattr(self, "_draws_key", None) != key:
            tables = [torch.as_tensor(_pop_draws(
                _chain_generator(seed, c), int(nsteps_total), int(nbins),
                int(mh_steps))) for c in range(nchains)]
            self._draws = torch.stack(tables).to(self.device)
            self._draws_key = key
        return self._draws

    def _mesh_pdfsT(self, mesh, pos0):
        """The (Nbins, Nobs) transposed PDFs split over `mesh`'s devices,
        the objects padded to a multiple of ``mesh.size`` with uniform
        rows, and the per-chain lnpost shift (nchains,) of those rows."""
        nobs, nbins = self.pdfs.shape
        npad = (-nobs) % mesh.size
        pdfs = np.concatenate([self.pdfs, np.full((npad, nbins),
                                                  1.0 / nbins)])
        per = pdfs.shape[0] // mesh.size
        shards = [torch.from_numpy(np.ascontiguousarray(
            pdfs[k * per:(k + 1) * per].T)).to(device=dev, dtype=self.dtype)
            for k, dev in enumerate(mesh.devices)]
        shift = npad * np.log(np.asarray(pos0).sum(axis=1) / nbins)
        return shards, shift

    def _start(self, pos0, prior, kernel, pdfsT=None, device=None):
        """The (pos, overlap, lnpost) carry of a run's first block, over
        `pdfsT` (the sampler's own by default, or a list of shards whose
        overlaps stay on their devices; pos and lnpost go to `device`)."""
        shards = pdfsT if isinstance(pdfsT, list) else [
            self._pdfsT() if pdfsT is None else pdfsT]
        pos = self._tensor(pos0).to(device or self.device)
        ovs = []
        for P in shards:
            # pdfs @ pos bin by bin, each product and sum rounded: the
            # same overlaps whatever the number of chains or the device
            # (a matmul picks its order by shape).
            p = pos.to(P.device)
            ov = p[:, :1] * P[0]
            for b in range(1, P.shape[0]):
                ov = ov + p[:, b:b + 1] * P[b]
            ovs.append(ov)
        if kernel:
            ov = ovs[0]
            tiny = _kpop.consts(ov.dtype, ov.device)["tiny"]
            lnp = _kpop.tree_sum(torch.log(torch.maximum(ov, tiny)),
                                 _kpop.chain_threads(ov.shape[1]))
        else:
            lnp = (_shard_sum([torch.log(ov).sum(dim=1) for ov in ovs],
                              pos.device)
                   + _prior_values(prior, pos))
        return pos, (ovs if isinstance(pdfsT, list) else ovs[0]), lnp

    def _blocks(self, Niter, logprior_nz, pos_init, thin, mh_steps, rng,
                seed, nchains, prior_args, prior_kwargs, mesh, use_kernel,
                block):
        """Run the chain `block` thinned samples at a time, yielding each
        block's (samples (nchains, nb, Nbins), lnps (nchains, nb)) as
        float64 arrays.  Chain c's table covers the whole run and each
        block takes its slice, from the previous block's exact carry."""
        prior = self._resolve_prior(logprior_nz, prior_args, prior_kwargs)
        pos0 = self._resolve_pos0(pos_init, nchains)
        nbins = pos0.shape[1]
        kernel = self._pick_route(use_kernel, prior, nbins, mh_steps, mesh)
        seed = self._resolve_seed(seed, rng)
        thin, mh_steps = int(thin), int(mh_steps)
        home, shift = self.device, 0.0
        if mesh is None:
            pdfsT = self._pdfsT()
        else:
            pdfsT, shift = self._mesh_pdfsT(mesh, pos0)
            home, shift = mesh.devices[0], shift[:, None]
        carry = None
        for i0 in range(0, Niter, block):
            nb = min(block, Niter - i0)
            draws = self._tables(seed, nchains, Niter * thin, nbins,
                                 mh_steps)[:, i0 * thin:(i0 + nb) * thin]
            if carry is None:
                carry = self._start(pos0, prior, kernel, pdfsT, home)
            if kernel:
                out = _kpop.pop_chain(
                    draws.to(torch.float32).contiguous(), pdfsT,
                    *carry, thin=thin, mh_steps=mh_steps)
            else:
                out = _pop_run(draws.to(device=home, dtype=self.dtype),
                               pdfsT, *carry, prior=prior, thin=thin,
                               mh_steps=mh_steps)
            carry = out[2:]
            yield (out[0].cpu().numpy().astype(float),
                   out[1].cpu().numpy().astype(float) - shift)

    def run_mcmc(self, Niter, logprior_nz=None, pos_init=None, thin=400,
                 mh_steps=3, rng=None, seed=None, verbose=True,
                 nchains=1, prior_args=(), prior_kwargs=None, mesh=None,
                 use_kernel=None):
        """Draw `Niter` (thinned) samples and append them to the stored
        chain (resume from the last stored sample, default init = stacked
        PDFs).

        ``use_kernel=None`` takes the kernel route (every chain in one
        `pop_chain` launch) when the configuration is eligible: the flat
        prior, float32, within the kernel's limits.  ``use_kernel=True``
        raises ValueError on an ineligible configuration;
        ``use_kernel=False`` takes the general route, which `mesh` (a
        `parallel.Mesh`) splits over its devices (see the module
        docstring; ``use_kernel=True`` with `mesh` raises).  A one-shard
        mesh gives the general route's single-device chain bit for bit.
        """
        t0 = time.time()
        for samples, lnps in self._blocks(
                Niter, logprior_nz, pos_init, thin, mh_steps, rng, seed,
                nchains, prior_args, prior_kwargs, mesh, use_kernel,
                block=max(int(Niter), 1)):
            self._store_run(samples, lnps, nchains, Niter)
        train_note(verbose, "population MCMC", Niter, t0)
        return self

    def sample(self, Niter, logprior_nz=None, pos_init=None, thin=400,
               mh_steps=3, rng=None, seed=None, verbose=True, nchains=1,
               prior_args=(), prior_kwargs=None, mesh=None, block=1,
               use_kernel=None):
        """Generator yielding one `(pos, lnpost)` per (thinned) sample, AS
        THE CHAIN RUNS: the chain advances `block` thinned samples per
        call of its route, so the first yield costs O(block * thin *
        mh_steps) proposals.  Blocks resume from the previous block's
        exact MH carry and take their slice of the run's one draw table,
        so for a given seed the stream equals `run_mcmc`'s (bit for bit
        on the kernel route).  This does NOT append to the stored chain;
        only `run_mcmc` does.
        """
        del verbose
        for samples, lnps in self._blocks(
                Niter, logprior_nz, pos_init, thin, mh_steps, rng, seed,
                nchains, prior_args, prior_kwargs, mesh, use_kernel,
                block=int(block)):
            for it in range(samples.shape[1]):
                if nchains == 1:
                    yield samples[0, it], float(lnps[0, it])
                else:
                    yield samples[:, it, :], lnps[:, it]
