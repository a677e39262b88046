"""Port parity for the samplers: the population sampler on both routes,
the hierarchical sampler, their log functions, and a chain carried across
from JAX.

The same NumPy inputs go through `frankenz_tpu`'s samplers (on the CPU,
x64; the population Pallas kernel in interpret mode, or its `lax.scan`)
and the port's (on CPU tensors: the `pop_chain` kernel's plain version,
or the general step loop).  Randomness is shared as a table of draws: the
kernel routes of both packages take one (JAX's own `_pop_draws` table, or
a scripted one), and for the general route the test rebuilds, from JAX's
keys, the draws its scan makes and packs them into the port's table.

Tolerances.  Kernel route against the Pallas kernel: samples rtol 2e-4 /
atol 2e-6, lnpost rtol 2e-5 / atol 2e-4, those of JAX's own scripted
differential (tests/test_reference_differential.py:1145-1148).  General
route against the scan, both float64: rtol 1e-6.  Log functions: 1e-6.
The hierarchical sampler draws from another generator than JAX's, so it
is held by distribution (tests/test_samplers.py's recovery criteria).

The kernel-route runs are held to JAX where the trajectories stay locked.
An accept compares -e with a difference of two float32 log-sums, JAX on
the CPU contracts a * b + c into one fused multiply-add and sums in
another order than the port's tree, so one ulp can flip an accept, after
which the chains part for good.  The seeds here (7 on the mock, 97 on the
scripted problem) are ones where no accept flips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

import _torch_port  # noqa: F401  (one torch thread per test worker)
from frankenz_tpu.samplers import hierarchical as JH
from frankenz_tpu.samplers import population as JP
from frankenz_tpu_torch.kernels import pop as PK
from frankenz_tpu_torch.samplers import (dirichlet_logpdf,
                                         hierarchical_sampler, loglike_nz,
                                         multinomial_logpmf,
                                         population_sampler)
from frankenz_tpu_torch.samplers import hierarchical as TH
from frankenz_tpu_torch.samplers import population as TP
from frankenz_tpu_torch.utils import sampler_from_jax

SAMPLE_TOL = dict(rtol=2e-4, atol=2e-6)
LNP_TOL = dict(rtol=2e-5, atol=2e-4)
MOCK_RUN = dict(thin=25, mh_steps=3)
MOCK_NITER, MOCK_SEED = 8, 7


@pytest.fixture(scope="module")
def mock_pdfs():
    """tests/test_samplers.py:18-34: 20 bins x 400 objects, Gaussian
    likelihoods around redshifts drawn from a bump at bin 7."""
    rng = np.random.default_rng(3)
    nbins, nobs = 20, 400
    grid = np.arange(nbins)
    nz_true = np.exp(-0.5 * ((grid - 7.0) / 2.5) ** 2)
    nz_true /= nz_true.sum()
    ztrue = rng.choice(nbins, size=nobs, p=nz_true)
    sig = 0.8
    centers = ztrue + rng.normal(0, sig, nobs)
    pdfs = np.exp(-0.5 * ((grid[None, :] - centers[:, None]) / sig) ** 2)
    pdfs /= pdfs.sum(axis=1, keepdims=True)
    return pdfs, nz_true, ztrue


@pytest.fixture(scope="module")
def scripted():
    """tests/test_reference_differential.py:1086-1102: 12 bins x 60
    objects, a uniform start and one scripted table of draws."""
    rng = np.random.default_rng(97)
    nobs, nbins = 60, 12
    niter, thin, mh = 15, 4, 2
    nsteps = niter * thin
    c = rng.uniform(1, 10, (nobs, 1))
    pdfs = np.exp(-0.5 * ((np.arange(nbins)[None] - c) / 2.0) ** 2) + 0.05
    pdfs /= pdfs.sum(axis=1, keepdims=True)
    ii = rng.integers(0, nbins, nsteps)
    jj = rng.integers(0, nbins - 1, nsteps)
    jj = jj + (jj >= ii)
    zs = rng.normal(size=(nsteps, mh)).astype(np.float32)
    es = rng.exponential(size=(nsteps, mh)).astype(np.float32)
    table = np.concatenate([ii[:, None].astype(np.float32),
                            jj[:, None].astype(np.float32), zs, es], axis=1)
    return dict(pdfs=pdfs, pos0=np.full(nbins, 1.0 / nbins), table=table,
                niter=niter, thin=thin, mh=mh)


def _smooth(nz, sig=2.0):
    grid = np.arange(nz.shape[-1])
    K = np.exp(-0.5 * ((grid[None, :] - grid[:, None]) / sig) ** 2)
    K /= K.sum(axis=1, keepdims=True)
    return nz @ K


def _jax_kernel_sampler(monkeypatch, pdfs, table=None):
    """A JAX population sampler forced onto its Pallas kernel (interpret
    mode on the CPU), fed `table` (chain-major list) when given."""
    monkeypatch.setattr(JP.population_sampler, "_kernel_ok",
                        lambda *a, **k: True)
    if table is not None:
        tables = iter(table)
        monkeypatch.setattr(
            JP, "_pop_draws",
            lambda key, *, nsteps, nbins, mh_steps: jnp.asarray(
                next(tables)[:nsteps]))
    return JP.population_sampler(pdfs)


def _feed_port(monkeypatch, tables):
    """Replace the port's `_pop_draws`: call c returns tables[c]; returns
    the list of requested lengths."""
    calls = []

    def fed(gen, nsteps, nbins, mh_steps):
        calls.append(nsteps)
        return torch.as_tensor(np.array(tables[len(calls) - 1][:nsteps]))

    monkeypatch.setattr(TP, "_pop_draws", fed)
    return calls


def _jax_tables(seed, nchains, nsteps, nbins, mh):
    """JAX's own kernel-route tables: chain c from fold_in(key, c)."""
    key = jax.random.key(seed)
    return [np.asarray(JP._pop_draws(jax.random.fold_in(key, c),
                                     nsteps=nsteps, nbins=nbins,
                                     mh_steps=mh)) for c in range(nchains)]


@pytest.fixture(scope="module")
def jax_mock_chain(mock_pdfs):
    """JAX's kernel-route chain on the mock (its own table, seed 7), run
    once for the tests that compare with it or resume from it."""
    mp = pytest.MonkeyPatch()
    samp = _jax_kernel_sampler(mp, mock_pdfs[0])
    samp.run_mcmc(MOCK_NITER, seed=MOCK_SEED, verbose=False, **MOCK_RUN)
    mp.undo()
    return samp


# ---------------------------------------------------------------------
# The kernel route against JAX's Pallas kernel.
# ---------------------------------------------------------------------


def test_kernel_route_matches_pallas_on_the_scripted_table(scripted,
                                                           monkeypatch):
    """The kernel's wrapper itself (its plain version here) and the JAX
    kernel, from the same start on the same scripted table."""
    s = scripted
    jsamp = _jax_kernel_sampler(monkeypatch, s["pdfs"], [s["table"]])
    want, want_lnp, carry = jsamp._run_kernel(
        jax.random.key(0), s["pos0"][None], s["niter"], s["thin"], s["mh"])
    pdfsT = torch.from_numpy(np.ascontiguousarray(
        s["pdfs"].T.astype(np.float32)))
    pos = torch.from_numpy(s["pos0"][None].astype(np.float32))
    ov = (pos @ pdfsT).contiguous()
    lnp = PK.tree_sum(torch.log(ov), PK.chain_threads(ov.shape[1]))
    got = PK.pop_chain(torch.from_numpy(s["table"][None]), pdfsT, pos, ov,
                       lnp, thin=s["thin"], mh_steps=s["mh"])
    np.testing.assert_allclose(got[0].numpy(), want, **SAMPLE_TOL)
    np.testing.assert_allclose(got[1].numpy(), want_lnp, **LNP_TOL)
    # The carry too: position, overlap, lnpost.
    jpos, jov, jlnp = (np.asarray(x) for x in carry[0])
    np.testing.assert_allclose(got[2].numpy()[0], jpos[0, :12], **SAMPLE_TOL)
    np.testing.assert_allclose(got[3].numpy()[0], jov[0, :60], rtol=2e-4)
    np.testing.assert_allclose(float(got[4]), jlnp[0, 0], **LNP_TOL)
    # The chain moved.
    assert not np.allclose(got[0].numpy()[0, -1], s["pos0"])


def test_entry_points_match_pallas_on_the_scripted_table(scripted,
                                                         monkeypatch):
    s = scripted
    jsamp = _jax_kernel_sampler(monkeypatch, s["pdfs"], [s["table"]])
    kw = dict(pos_init=s["pos0"], thin=s["thin"], mh_steps=s["mh"], seed=0,
              verbose=False)
    jsamp.run_mcmc(s["niter"], **kw)
    calls = _feed_port(monkeypatch, [s["table"]])
    PK.reset_launch_counts()
    ours = population_sampler(s["pdfs"], device="cpu")
    ours.run_mcmc(s["niter"], **kw)
    assert calls == [s["niter"] * s["thin"]]
    # CPU: the plain version, neither route of the kernel.
    assert PK.launch_counts() == {"pop_chain": 0, "pop_chain_cluster": 0}
    got, got_lnp = ours.results
    want, want_lnp = jsamp.results
    assert got.shape == (s["niter"], 12) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, **SAMPLE_TOL)
    np.testing.assert_allclose(got_lnp, want_lnp, **LNP_TOL)


def test_entry_points_match_pallas_on_jax_own_table(mock_pdfs, jax_mock_chain,
                                                    monkeypatch):
    pdfs = mock_pdfs[0]
    nsteps = MOCK_NITER * MOCK_RUN["thin"]
    _feed_port(monkeypatch, _jax_tables(MOCK_SEED, 1, nsteps, 20, 3))
    ours = population_sampler(pdfs, device="cpu")
    ours.run_mcmc(MOCK_NITER, seed=MOCK_SEED, verbose=False, **MOCK_RUN)
    got, got_lnp = ours.results
    want, want_lnp = jax_mock_chain.results
    np.testing.assert_allclose(got, want, **SAMPLE_TOL)
    np.testing.assert_allclose(got_lnp, want_lnp, **LNP_TOL)
    # A chain, not a copy of its start.
    stack = pdfs.sum(axis=0) / pdfs.sum()
    assert not np.allclose(got[-1], stack)
    np.testing.assert_allclose(got_lnp[-1], np.sum(np.log(pdfs @ got[-1])),
                               rtol=1e-3)


def test_three_chains_match_pallas_and_interleave(mock_pdfs, monkeypatch):
    pdfs = mock_pdfs[0]
    niter, kw = 4, dict(thin=25, mh_steps=3, seed=MOCK_SEED, nchains=3,
                        verbose=False)
    jsamp = _jax_kernel_sampler(monkeypatch, pdfs)
    jsamp.run_mcmc(niter, **kw)
    _feed_port(monkeypatch, _jax_tables(MOCK_SEED, 3, niter * 25, 20, 3))
    ours = population_sampler(pdfs, device="cpu")
    ours.run_mcmc(niter, **kw)
    got, got_lnp = ours.results
    want, want_lnp = jsamp.results
    assert got.shape == (niter * 3, 20) and got_lnp.shape == (niter * 3,)
    np.testing.assert_allclose(got, want, **SAMPLE_TOL)
    np.testing.assert_allclose(got_lnp, want_lnp, **LNP_TOL)
    by_chain, lnp_by_chain = ours.results_by_chain
    assert by_chain.shape == (niter, 3, 20)
    assert lnp_by_chain.shape == (niter, 3)
    # Sample s of chain c is row s * nchains + c of `results`.
    np.testing.assert_array_equal(by_chain[2, 1], got[2 * 3 + 1])
    assert lnp_by_chain[2, 1] == got_lnp[2 * 3 + 1]
    assert not np.allclose(by_chain[-1, 0], by_chain[-1, 1])


@pytest.mark.parametrize("nchains", [1, 2])
def test_sample_in_blocks_is_bit_equal_to_run_mcmc(mock_pdfs, monkeypatch,
                                                   nchains):
    """Blocks of 3 thinned samples from the exact carry stream the chain
    that `run_mcmc` stores, samples and lnpost, and every chain's table is
    drawn once (the twin of tests/test_samplers.py:229-247)."""
    pdfs = mock_pdfs[0]
    kw = dict(seed=MOCK_SEED, nchains=nchains, **MOCK_RUN)
    samp = population_sampler(pdfs, device="cpu")
    samp.run_mcmc(MOCK_NITER, verbose=False, **kw)
    want, want_lnp = samp.results_by_chain
    ndraws = []
    orig = TP._pop_draws

    def counting(gen, nsteps, nbins, mh_steps):
        ndraws.append(nsteps)
        return orig(gen, nsteps, nbins, mh_steps)

    monkeypatch.setattr(TP, "_pop_draws", counting)
    fresh = population_sampler(pdfs, device="cpu")
    got = list(fresh.sample(MOCK_NITER, block=3, **kw))
    assert ndraws == [MOCK_NITER * MOCK_RUN["thin"]] * nchains
    assert len(got) == MOCK_NITER
    assert fresh.samples == [] and fresh._chain_state is None
    for i, (pos, lnp) in enumerate(got):
        np.testing.assert_array_equal(np.atleast_2d(pos), want[i])
        np.testing.assert_array_equal(np.atleast_1d(lnp), want_lnp[i])


def test_seeded_tables_are_reproducible_and_well_formed():
    a = TP._pop_draws(TP._chain_generator(5, 0), 500, 7, 3)
    b = TP._pop_draws(TP._chain_generator(5, 0), 500, 7, 3)
    c = TP._pop_draws(TP._chain_generator(5, 1), 500, 7, 3)
    assert a.dtype == torch.float32 and a.shape == (500, 8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    i, j = a[:, 0], a[:, 1]
    assert bool((i != j).all())
    assert set(i.tolist()) == set(range(7)) == set(j.tolist())
    assert bool((a[:, 5:] >= 0).all()) and abs(float(a[:, 5:].mean()) - 1) < .1
    assert abs(float(a[:, 2:5].mean())) < 0.1
    # j is uniform over the bins other than i.
    assert bool((j[i == 3] != 3).all())


def test_resolve_seed_follows_the_jax_rule():
    resolve = population_sampler._resolve_seed
    assert resolve(3, np.random.default_rng(0)) == 3
    want = int(np.random.default_rng(0).integers(2**31))
    assert resolve(None, np.random.default_rng(0)) == want
    assert 0 <= resolve(None, None) < 2**31
    assert isinstance(resolve(np.int64(5), None), int)


def test_resume_and_stacked_pdf_start(mock_pdfs):
    """The twin of tests/test_samplers.py:106-117: the default start is
    the stacked PDFs, as in JAX, and a second run resumes from the stored
    chain state."""
    pdfs = mock_pdfs[0]
    samp = population_sampler(pdfs, device="cpu")
    np.testing.assert_array_equal(
        samp._resolve_pos0(None, 4),
        JP.population_sampler(pdfs)._resolve_pos0(None, 4))
    samp.run_mcmc(3, thin=10, seed=2, nchains=4, verbose=False)
    s, lnp = samp.results_by_chain
    assert s.shape == (3, 4, 20) and lnp.shape == (3, 4)
    assert not np.allclose(s[-1, 0], s[-1, 1])
    np.testing.assert_array_equal(samp._resolve_pos0(None, 4), s[-1])
    samp.run_mcmc(2, thin=10, seed=3, nchains=4, verbose=False)
    s2, _ = samp.results_by_chain
    assert s2.shape == (5, 4, 20)
    np.testing.assert_array_equal(s2[:3], s)
    # The resumed run started where the first ended: it equals a fresh
    # sampler's run from that position, not one from the stack.
    kw = dict(thin=10, seed=3, nchains=4, verbose=False)
    fresh = population_sampler(pdfs, device="cpu")
    fresh.run_mcmc(2, pos_init=s[-1], **kw)
    np.testing.assert_array_equal(fresh.results_by_chain[0], s2[3:])
    fresh.reset()
    fresh.run_mcmc(2, **kw)
    assert not np.allclose(fresh.results_by_chain[0], s2[3:])
    samp.reset()
    assert samp.samples == [] and samp._chain_state is None
    # An explicit start wins over the stored state.
    np.testing.assert_array_equal(
        samp._resolve_pos0(np.full(20, 0.05), 2), np.full((2, 20), 0.05))


def test_a_jax_chain_carries_across(mock_pdfs, jax_mock_chain, monkeypatch):
    """`sampler_from_jax`: the port resumes from JAX's last position, as
    JAX itself does when it runs on, and `results` holds both parts."""
    pdfs = mock_pdfs[0]
    ours = sampler_from_jax(jax_mock_chain, "cpu")
    assert type(ours) is population_sampler
    want0, want0_lnp = jax_mock_chain.results
    np.testing.assert_array_equal(ours.results[0], want0)
    np.testing.assert_array_equal(ours._resolve_pos0(None, 1),
                                  jax_mock_chain._resolve_pos0(None, 1))
    # JAX runs on with its own table for seed 9; the port takes the same.
    jsamp = _jax_kernel_sampler(monkeypatch, pdfs)
    jsamp.samples = list(jax_mock_chain.samples)
    jsamp.samples_lnp = list(jax_mock_chain.samples_lnp)
    jsamp._chain_state = jax_mock_chain._chain_state
    jsamp.run_mcmc(MOCK_NITER, seed=9, verbose=False, **MOCK_RUN)
    _feed_port(monkeypatch, _jax_tables(
        9, 1, MOCK_NITER * MOCK_RUN["thin"], 20, 3))
    ours.run_mcmc(MOCK_NITER, seed=9, verbose=False, **MOCK_RUN)
    got, got_lnp = ours.results
    want, want_lnp = jsamp.results
    assert got.shape == (2 * MOCK_NITER, 20)
    np.testing.assert_array_equal(got[:MOCK_NITER], want0)
    np.testing.assert_allclose(got, want, **SAMPLE_TOL)
    np.testing.assert_allclose(got_lnp, want_lnp, **LNP_TOL)
    # A hierarchical sampler carries across by its class name.
    jh = JH.hierarchical_sampler(pdfs)
    jh.samples, jh.samples_lnp = [want0[0], want0[1]], [-1.0, -2.0]
    th = sampler_from_jax(jh, "cpu")
    assert type(th) is hierarchical_sampler and th.dtype == torch.float32
    np.testing.assert_array_equal(th.results[0], want0[:2])
    np.testing.assert_array_equal(th._resolve_pos0(None, 1), want0[1:2])


# ---------------------------------------------------------------------
# The general route against JAX's scan.
# ---------------------------------------------------------------------


def _scan_tables(seed, nchains, niter, thin, nbins, mh):
    """The draws JAX's scan makes from its keys (population.py:386-418:
    split the step key, `choice` for the pair, split again per proposal,
    then `normal` and `exponential`), packed as the port's tables:
    (nchains, niter * thin, 2 + 2 * mh), float64 under x64."""

    def step_draws(key):
        kpair, kmh = jax.random.split(key)
        ij = jax.random.choice(kpair, nbins, (2,), replace=False)

        def proposal(k):
            kz, ke = jax.random.split(k)
            return jax.random.normal(kz), jax.random.exponential(ke)

        z, e = jax.vmap(proposal)(jax.random.split(kmh, mh))
        return jnp.concatenate([ij.astype(z.dtype), z, e])

    def outer(key):
        return jax.vmap(step_draws)(jax.random.split(key, thin))

    keys = jax.random.split(jax.random.key(seed), (nchains, niter))
    tab = np.asarray(jax.vmap(jax.vmap(outer))(keys))
    return tab.reshape(nchains, niter * thin, 2 + 2 * mh)


ALPHA = 2.0


def _jax_dirichlet_prior(pos, alpha):
    return jnp.sum((alpha - 1.0) * jnp.log(pos))


def _torch_dirichlet_prior(pos, alpha):
    return ((alpha - 1.0) * torch.log(pos)).sum()


@pytest.mark.parametrize("prior", ["flat", "dirichlet"])
def test_general_route_matches_the_scan_exactly(mock_pdfs, monkeypatch,
                                                prior):
    pdfs = mock_pdfs[0]
    niter, thin, mh, nchains, seed = 5, 12, 2, 2, 13
    kw = dict(thin=thin, mh_steps=mh, seed=seed, nchains=nchains,
              verbose=False)
    jkw, tkw = {}, dict(use_kernel=False)
    if prior == "dirichlet":
        jkw = dict(logprior_nz=_jax_dirichlet_prior, prior_args=(ALPHA,))
        tkw = dict(logprior_nz=_torch_dirichlet_prior,
                   prior_kwargs=dict(alpha=ALPHA))
    jsamp = JP.population_sampler(pdfs)  # the CPU has no Pallas: the scan
    jsamp.run_mcmc(niter, **kw, **jkw)
    tables = _scan_tables(seed, nchains, niter, thin, 20, mh)
    assert tables.dtype == np.float64
    _feed_port(monkeypatch, list(tables))
    ours = population_sampler(pdfs, device="cpu", dtype=torch.float64)
    ours.run_mcmc(niter, **kw, **tkw)
    got, got_lnp = ours.results
    want, want_lnp = jsamp.results
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got_lnp, np.asarray(want_lnp), rtol=1e-6)
    stack = pdfs.sum(axis=0) / pdfs.sum()
    assert not np.allclose(got[-1], stack)
    if prior == "dirichlet":
        # The stored lnpost includes the prior.
        lnl = np.sum(np.log(pdfs @ got[-1]))
        np.testing.assert_allclose(
            got_lnp[-1], lnl + np.sum((ALPHA - 1) * np.log(got[-1])),
            rtol=1e-6)
    # Blocks from the exact carry stream the same chain.
    _feed_port(monkeypatch, list(tables))
    fresh = population_sampler(pdfs, device="cpu", dtype=torch.float64)
    for i, (pos, lnp) in enumerate(fresh.sample(niter, block=2, **kw,
                                                **tkw)):
        np.testing.assert_array_equal(pos, ours.results_by_chain[0][i])
        np.testing.assert_array_equal(lnp, ours.results_by_chain[1][i])


# ---------------------------------------------------------------------
# Where JAX's two routes differ, each port route follows its twin.
# ---------------------------------------------------------------------


def _zero_overlap_problem(seed=41, nbins=12, nobs=60):
    """No mass in the last 4 bins, and 5 objects with PDFs in those bins
    only: their overlaps are 0."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, nbins - 1, (nobs, 1))
    pdfs = np.exp(-0.5 * ((np.arange(nbins)[None] - c) / 1.5) ** 2) + 0.01
    pdfs[:5, :nbins - 4] = 0.0
    pdfs[5:, nbins - 4:] = 0.0
    pdfs /= pdfs.sum(axis=1, keepdims=True)
    pos0 = rng.dirichlet(np.full(nbins, 5.0))
    pos0[nbins - 4:] = 0.0
    return pdfs, pos0 / pos0.sum()


def test_kernel_route_follows_pallas_on_the_floor_and_negative_bins(
        monkeypatch):
    """Zero overlaps sit on the 1e-30 floor in lnpost, and a move to a
    negative bin scores -3.0e38: with an infinite exponential in the last
    step's draw that move is accepted, in both packages."""
    pdfs, pos0 = _zero_overlap_problem()
    niter, thin, mh = 6, 5, 2
    rng = np.random.default_rng(5)
    ii = rng.integers(0, 8, niter * thin)  # pairs among the bins with mass
    jj = rng.integers(0, 7, niter * thin)
    jj = jj + (jj >= ii)
    table = np.concatenate(
        [ii[:, None], jj[:, None], rng.normal(size=(niter * thin, mh)),
         rng.exponential(size=(niter * thin, mh))], axis=1).astype(np.float32)
    table[-1, 2:4] = 50.0       # far past the bin's mass
    table[-1, 4:6] = np.inf     # -e = -inf < -3.0e38 - lnpost
    kw = dict(pos_init=pos0, thin=thin, mh_steps=mh, seed=0, verbose=False)
    jsamp = _jax_kernel_sampler(monkeypatch, pdfs, [table])
    jsamp.run_mcmc(niter, **kw)
    _feed_port(monkeypatch, [table])
    ours = population_sampler(pdfs, device="cpu")
    ours.run_mcmc(niter, **kw)
    got, got_lnp = ours.results
    want, want_lnp = jsamp.results
    np.testing.assert_allclose(got, want, **SAMPLE_TOL)
    np.testing.assert_allclose(got_lnp, want_lnp, **LNP_TOL)
    floor = 5 * float(np.log(np.float32(1e-30)))
    rest = np.sum(np.log((pdfs @ got[-2])[5:]))
    np.testing.assert_allclose(got_lnp[-2], rest + floor, rtol=1e-5)
    assert got_lnp[-1] == np.float32(-3.0e38) == want_lnp[-1]
    assert got[-1].min() < 0 and np.asarray(want)[-1].min() < 0


def test_general_route_follows_the_scan_on_zero_overlaps_and_negative_bins(
        monkeypatch):
    """The scan sums log(ov) and scores a negative bin -inf.  With a zero
    overlap lnpost is -inf from the start and no proposal is ever
    accepted (-inf - -inf is NaN): the chain stays where it started, in
    both packages, while the kernel route moves.  A move to a negative
    bin is rejected even under an infinite exponential."""
    pdfs, pos0 = _zero_overlap_problem()
    niter, thin, mh, seed = 3, 4, 2, 3
    kw = dict(pos_init=pos0, thin=thin, mh_steps=mh, seed=seed,
              verbose=False)
    jsamp = JP.population_sampler(pdfs)
    jsamp.run_mcmc(niter, **kw)
    tables = _scan_tables(seed, 1, niter, thin, 12, mh)
    _feed_port(monkeypatch, list(tables))
    ours = population_sampler(pdfs, device="cpu", dtype=torch.float64)
    ours.run_mcmc(niter, use_kernel=False, **kw)
    got, got_lnp = ours.results
    want, want_lnp = jsamp.results
    np.testing.assert_array_equal(got, np.tile(pos0, (niter, 1)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12)
    assert (got_lnp == -np.inf).all() and (np.asarray(want_lnp)
                                           == -np.inf).all()
    _feed_port(monkeypatch, list(tables.astype(np.float32)))
    moved = population_sampler(pdfs, device="cpu")
    moved.run_mcmc(niter, **kw)
    assert np.isfinite(moved.results[1]).all()
    assert not np.allclose(moved.results[0][-1], pos0)
    # One step on positive overlaps, far past bin 0's mass, e infinite:
    # the general route scores -inf and stays; the kernel route's -3.0e38
    # is accepted.
    pdfs2 = pdfs[5:, :8] / pdfs[5:, :8].sum(axis=1, keepdims=True)
    start = np.full(8, 0.125)
    row = np.array([[0, 1, 50.0, np.inf]], np.float32)
    out = {}
    for route in (False, True):
        _feed_port(monkeypatch, [row])
        s = population_sampler(pdfs2, device="cpu")
        s.run_mcmc(1, pos_init=start, thin=1, mh_steps=1, seed=0,
                   verbose=False, use_kernel=route)
        out[route] = s.results
    np.testing.assert_allclose(out[False][0][0], start, rtol=1e-6)
    assert np.isfinite(out[False][1][0])
    assert out[True][0][0].min() < 0 and out[True][1][0] == np.float32(-3e38)


# ---------------------------------------------------------------------
# The functions.
# ---------------------------------------------------------------------


def test_loglike_nz_matches_jax(mock_pdfs):
    pdfs, nz_true, _ = mock_pdfs
    got = loglike_nz(nz_true, pdfs)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(JP.loglike_nz(nz_true, pdfs)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got), np.sum(np.log(pdfs @ nz_true)),
                               rtol=1e-6)
    kw = dict(pair=(2, 5), pair_step=1e-3, return_overlap=True)
    got_p, got_ov = loglike_nz(nz_true, pdfs, **kw)
    want_p, want_ov = JP.loglike_nz(nz_true, pdfs, **kw)
    np.testing.assert_allclose(float(got_p), float(want_p), rtol=1e-6)
    np.testing.assert_allclose(got_ov.numpy(), np.asarray(want_ov), rtol=1e-6)
    # A carried overlap is used as given.
    ov = pdfs @ nz_true
    np.testing.assert_allclose(
        float(loglike_nz(nz_true, pdfs, overlap=2 * ov)),
        float(JP.loglike_nz(nz_true, pdfs, overlap=2 * ov)), rtol=1e-6)
    # Negative and non-finite positions are rejected.
    for bad_value in (-0.1, np.nan, np.inf):
        bad = nz_true.copy()
        bad[0] = bad_value
        lnl, ov_bad = loglike_nz(bad, pdfs, return_overlap=True)
        assert float(lnl) == -np.inf == float(JP.loglike_nz(bad, pdfs))
        assert bool((ov_bad == 0).all())
    # float32 in, float32 out.
    assert loglike_nz(nz_true.astype(np.float32),
                      pdfs.astype(np.float32)).dtype == torch.float32


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gradient_terms_match_jax_on_both_branches(dtype):
    """`_log1p_f32`: the series below 1e-3 and log(1 + x) above;
    `_pair_dlnl_terms`: the ratio form, and the clamped difference where
    |half| >= ov or ov is at the floor."""
    x = np.array([0.0, 1e-7, -1e-7, 5e-4, -9.99e-4, 1e-3, -1e-3, 2e-3, 0.3,
                  -0.5, 7.0], dtype)
    got = TP._log1p_f32(torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(JP._log1p_f32(
        jnp.asarray(x))), rtol=1e-6)
    # Against the exact value: the series truncates below x^3 / 4, and
    # log(1 + x) cancels to eps / |x| (6e-5 in float32 at 1e-3).
    exact_tol = 1e-4 if dtype == np.float32 else 1e-6
    np.testing.assert_allclose(got.numpy(), np.log1p(x.astype(float)),
                               rtol=exact_tol, atol=1e-12)
    ov = np.array([0.1, 0.1, 0.1, 0.1, 1e-3, 1e-3, 0.0, 1e-26, 1e-20, 0.05],
                  dtype)
    half = np.array([1e-6, -1e-6, 0.05, -0.03, 1e-3, 2e-3, 1e-5, 0.0, 1e-21,
                     -0.2], dtype)
    got = TP._pair_dlnl_terms(torch.from_numpy(ov), torch.from_numpy(half))
    want = np.asarray(JP._pair_dlnl_terms(jnp.asarray(ov), jnp.asarray(half)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # Both branches were taken.
    ok = ov - np.abs(half) > 1e-25
    assert ok.any() and (~ok).any()
    clamp = np.log(np.maximum(ov + half, 1e-30).astype(float)) - np.log(
        np.maximum(ov - half, 1e-30).astype(float))
    np.testing.assert_allclose(got.numpy()[~ok], clamp[~ok], rtol=exact_tol)
    exact = np.log((ov[ok].astype(float) + half[ok]) / (ov[ok].astype(float)
                                                        - half[ok]))
    np.testing.assert_allclose(got.numpy()[ok], exact, rtol=exact_tol,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_logpmf_and_logpdf_match_jax_and_scipy(dtype):
    rng = np.random.default_rng(0)
    tol = 1e-6 if dtype == np.float64 else 2e-5
    p = rng.dirichlet(np.ones(6))
    counts = rng.multinomial(50, p).astype(dtype)
    got = multinomial_logpmf(counts, 50.0, p)
    assert got.dtype == torch.from_numpy(counts).dtype
    np.testing.assert_allclose(float(got), sps.multinomial.logpmf(
        counts, 50, p), rtol=tol)
    np.testing.assert_allclose(float(got), float(JH.multinomial_logpmf(
        counts, 50.0, p.astype(dtype))), rtol=tol)
    # Zero probabilities with zero counts contribute 0.
    p0 = np.array([0.5, 0.5, 0.0])
    np.testing.assert_allclose(
        float(multinomial_logpmf(np.array([3.0, 2.0, 0.0], dtype), 5.0, p0)),
        sps.multinomial.logpmf([3, 2, 0], 5, p0), rtol=tol)
    alpha = rng.uniform(0.5, 3.0, 6)
    x = rng.dirichlet(alpha).astype(dtype)
    got = dirichlet_logpdf(x, alpha)
    np.testing.assert_allclose(float(got), sps.dirichlet.logpdf(
        x.astype(float) / x.astype(float).sum(), alpha), rtol=10 * tol)
    np.testing.assert_allclose(float(got), float(JH.dirichlet_logpdf(
        x, alpha.astype(dtype))), rtol=tol)
    # A batch of chains.
    xs = rng.dirichlet(alpha, 3).astype(dtype)
    np.testing.assert_allclose(
        dirichlet_logpdf(xs, alpha).numpy(),
        [float(dirichlet_logpdf(v, alpha)) for v in xs], rtol=tol)


# ---------------------------------------------------------------------
# The hierarchical sampler, by distribution.
# ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hierarchical_sampler_recovers_truth(mock_pdfs, dtype):
    """The criteria of tests/test_samplers.py:120-135, and the posterior
    mean beside JAX's own (two Monte-Carlo estimates of one posterior)."""
    pdfs, nz_true, ztrue = mock_pdfs
    samp = hierarchical_sampler(pdfs, device="cpu", dtype=dtype)
    samp.run_mcmc(60, thin=5, seed=4, verbose=False)
    samples, lnps = samp.results
    assert samples.shape == (60, 20) and samples.dtype == np.float64
    np.testing.assert_allclose(samples.sum(axis=1), 1.0, atol=1e-3)
    assert np.isfinite(lnps).all()
    post = samples[20:].mean(axis=0)
    emp = np.bincount(ztrue, minlength=20) / len(ztrue)
    stack = pdfs.sum(axis=0) / pdfs.sum()
    err_post = np.abs(_smooth(post) - _smooth(emp)).sum()
    err_stack = np.abs(_smooth(stack) - _smooth(emp)).sum()
    assert err_post < err_stack
    grid = np.arange(20)
    assert abs(post @ grid - emp @ grid) < 0.3
    jsamp = JH.hierarchical_sampler(pdfs)
    jsamp.run_mcmc(60, thin=5, seed=4, verbose=False)
    jpost = np.asarray(jsamp.results[0])[20:].mean(axis=0)
    assert np.abs(_smooth(post) - _smooth(jpost)).sum() < err_stack / 2
    assert abs(lnps[20:].mean() - np.asarray(jsamp.results[1])[20:].mean()) \
        < 4 * np.asarray(jsamp.results[1])[20:].std() + 1.0


def test_hierarchical_with_reference_sample_and_chains(mock_pdfs):
    pdfs, nz_true, _ = mock_pdfs
    rng = np.random.default_rng(5)
    ref = rng.multinomial(200, nz_true).astype(float)
    samp = hierarchical_sampler(pdfs, device="cpu")
    samp.run_mcmc(10, thin=5, seed=6, ref_sample=ref, verbose=False)
    samples, lnps = samp.results
    assert samples.shape == (10, 20)
    assert np.isfinite(lnps).all()
    np.testing.assert_allclose(samples.sum(axis=1), 1.0, atol=1e-3)
    # The reference sample pulls the posterior toward its own counts.
    far = np.roll(ref, 8)
    pulled = hierarchical_sampler(pdfs, device="cpu")
    pulled.run_mcmc(10, thin=5, seed=6, ref_sample=50 * far, verbose=False)
    grid = np.arange(20)
    assert (pulled.results[0][5:].mean(axis=0) @ grid
            > samples[5:].mean(axis=0) @ grid + 1.0)
    hyper = samp._resolve_hyper(None, None, ref)
    jhyper = JH.hierarchical_sampler(pdfs)._resolve_hyper(None, None, ref)
    for a, b in zip(hyper, jhyper):
        np.testing.assert_array_equal(a, b)
    multi = hierarchical_sampler(pdfs, device="cpu")
    multi.run_mcmc(4, thin=3, seed=1, nchains=3, ref_sample=ref,
                   verbose=False)
    s, lnp = multi.results_by_chain
    assert s.shape == (4, 3, 20) and lnp.shape == (4, 3)
    assert not np.allclose(s[-1, 0], s[-1, 1])
    multi.run_mcmc(2, thin=3, seed=2, nchains=3, verbose=False)
    assert multi.results_by_chain[0].shape == (6, 3, 20)


@pytest.mark.parametrize("ref", [False, True])
def test_hierarchical_sample_matches_run_mcmc(mock_pdfs, ref):
    """A seeded `sample`, in blocks from the full (position, reference
    counts) carry, streams the chain a seeded `run_mcmc` stores, and
    leaves the sampler's state alone (tests/test_samplers.py:150-165)."""
    pdfs, nz_true, _ = mock_pdfs
    kw = dict(thin=3, seed=11)
    if ref:
        kw["ref_sample"] = np.random.default_rng(5).multinomial(
            200, nz_true).astype(float)
    s = hierarchical_sampler(pdfs, device="cpu")
    got = list(s.sample(5, block=2, **kw))
    assert len(got) == 5
    assert s.samples == [] and s.samples_lnp == [] and s._chain_state is None
    s.run_mcmc(5, verbose=False, **kw)
    want, want_lnp = s.results
    for i, (pos, lnp) in enumerate(got):
        np.testing.assert_array_equal(pos, want[i])
        np.testing.assert_allclose(lnp, want_lnp[i])


def test_sample_generators_stream_lazily(mock_pdfs, monkeypatch):
    """Taking 3 samples from a generator costs 3 small block calls, not
    the full-Niter chain (tests/test_samplers.py:168-203)."""
    pdfs = mock_pdfs[0]
    calls = []
    orig_pop = TP._pop_run

    def counting_pop(draws, *a, **kw):
        calls.append(draws.shape[1])
        return orig_pop(draws, *a, **kw)

    monkeypatch.setattr(TP, "_pop_run", counting_pop)
    s = population_sampler(pdfs, device="cpu")
    gen = s.sample(100_000, seed=0, thin=5, mh_steps=2, use_kernel=False)
    got = [next(gen) for _ in range(3)]
    gen.close()
    assert calls == [5, 5, 5]
    assert all(np.isfinite(lnp) for _, lnp in got)

    calls.clear()
    orig_chain = PK.pop_chain

    def counting_chain(draws, *a, **kw):
        calls.append(draws.shape[1])
        return orig_chain(draws, *a, **kw)

    monkeypatch.setattr(PK, "pop_chain", counting_chain)
    gen = s.sample(100_000, seed=0, thin=5, mh_steps=2, block=2)
    got = [next(gen) for _ in range(3)]
    gen.close()
    assert calls == [10, 10]

    calls.clear()
    orig_hier = TH._hier_run

    def counting_hier(*a, **kw):
        calls.append(kw["niter"])
        return orig_hier(*a, **kw)

    monkeypatch.setattr(TH, "_hier_run", counting_hier)
    h = hierarchical_sampler(pdfs, device="cpu")
    gen = h.sample(100_000, seed=0, thin=2, block=2)
    got = [next(gen) for _ in range(3)]
    gen.close()
    assert calls == [2, 2]  # 3 samples = two 2-sample blocks
    assert all(np.isfinite(lnp) for _, lnp in got)


# ---------------------------------------------------------------------
# Refusals.
# ---------------------------------------------------------------------


@pytest.mark.parametrize("cls", [population_sampler, hierarchical_sampler])
def test_samplers_default_to_the_card_and_raise_without_one(mock_pdfs, cls,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        cls(mock_pdfs[0])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        cls(mock_pdfs[0], device="cuda")
    samp = cls(mock_pdfs[0], device="cpu")
    assert samp.pdfs.dtype == np.float64 and samp.dtype == torch.float32


@pytest.mark.parametrize("cls", [population_sampler, hierarchical_sampler])
def test_mesh_raises(mock_pdfs, cls):
    """mesh= takes a `parallel.Mesh`; the population sampler's kernel
    route does not run under one (JAX population.py:655)."""
    from frankenz_tpu_torch.parallel import make_mesh

    samp = cls(mock_pdfs[0], device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        samp.run_mcmc(2, mesh=object(), verbose=False)
    with pytest.raises(TypeError, match="mesh"):
        next(samp.sample(2, mesh=object()))
    if cls is population_sampler:
        with pytest.raises(ValueError, match="kernel route"):
            samp.run_mcmc(2, mesh=make_mesh(devices=["cpu"] * 2),
                          use_kernel=True, verbose=False)
    assert samp.samples == []


def test_use_kernel_true_raises_where_the_kernel_cannot_run(mock_pdfs):
    pdfs = mock_pdfs[0]
    samp = population_sampler(pdfs, device="cpu")
    kw = dict(thin=2, seed=0, verbose=False, use_kernel=True)
    with pytest.raises(ValueError, match="flat prior"):
        samp.run_mcmc(2, logprior_nz=_torch_dirichlet_prior,
                      prior_args=(ALPHA,), **kw)
    with pytest.raises(ValueError, match="mh_steps"):
        samp.run_mcmc(2, mh_steps=64, **kw)
    wide = np.full((30, PK.MAX_BINS + 1), 1.0 / (PK.MAX_BINS + 1))
    with pytest.raises(ValueError, match="bins"):
        population_sampler(wide, device="cpu").run_mcmc(2, **kw)
    with pytest.raises(ValueError, match="float32"):
        population_sampler(pdfs, device="cpu", dtype=torch.float64).run_mcmc(
            2, **kw)
    assert samp.samples == []
    # Every configuration JAX's rule admits is within the kernel's limits.
    prior = samp._resolve_prior(None, (), None)
    assert samp._kernel_ok(prior, 20, 3) and samp._kernel_ok(prior, 128, 63)
    assert not samp._kernel_ok(prior, 20, 64)
    assert not samp._kernel_ok(prior, 129, 3)
    assert not samp._kernel_ok(_torch_dirichlet_prior, 20, 3)


def test_past_the_limits_the_default_takes_the_general_route(mock_pdfs,
                                                             monkeypatch):
    """The twin of tests/test_samplers.py:250-267: mh_steps 64 does not fit
    a draw row, so `use_kernel=None` runs the step loop, finite."""
    called = []
    monkeypatch.setattr(PK, "pop_chain", lambda *a, **k: called.append(1))
    s = population_sampler(mock_pdfs[0], device="cpu")
    s.run_mcmc(2, thin=2, mh_steps=64, seed=0, verbose=False)
    samples, lnps = s.results
    assert not called and samples.shape == (2, 20)
    assert np.isfinite(lnps).all()
    np.testing.assert_allclose(samples.sum(axis=1), 1.0, atol=1e-5)
