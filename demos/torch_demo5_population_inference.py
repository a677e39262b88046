"""
Demo 5 on the PyTorch port — Population Inference (the workflow of
`demo5_population_inference.py` on `frankenz_tpu_torch`).

Recovers a known N(z) from mock Gaussian redshift PDFs: naive stacking is
biased (over-dispersed by the kernel width) while the MH-in-Gibbs
population sampler recovers the truth within credible intervals.  The
chains run on `device` (the card by default: one `pop_chain` launch for
all chains under the flat prior).

Run:  python demos/torch_demo5_population_inference.py
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_mock_pdfs(nobs=1000, nbins=60, sig=0.1, seed=10):
    rng = np.random.default_rng(seed)
    grid = np.linspace(0.0, 3.0, nbins)
    nz = np.exp(-0.5 * ((grid - 1.0) / 0.35) ** 2) \
        + 0.5 * np.exp(-0.5 * ((grid - 1.9) / 0.2) ** 2)
    nz /= nz.sum()
    ztrue = rng.choice(nbins, size=nobs, p=nz)
    centers = grid[ztrue] + rng.normal(0, sig, nobs)
    pdfs = np.exp(-0.5 * ((grid[None, :] - centers[:, None]) / sig) ** 2)
    pdfs /= pdfs.sum(axis=1, keepdims=True)
    return grid, nz, ztrue, pdfs


def main(out="demos/output", nobs=1000, niter=200, thin=400, nchains=2,
         plot=True, device="cuda"):
    from frankenz_tpu_torch.samplers import population_sampler

    os.makedirs(out, exist_ok=True)
    grid, nz_true, ztrue, pdfs = make_mock_pdfs(nobs=nobs)
    emp = np.bincount(ztrue, minlength=len(grid)) / nobs

    sampler = population_sampler(pdfs, device=device)
    sampler.run_mcmc(niter, thin=thin, nchains=nchains, seed=3,
                     verbose=False)
    samples, lnps = sampler.results
    burn = len(samples) // 2
    post = samples[burn:]
    mean, lo, hi = (post.mean(axis=0), np.percentile(post, 2.5, axis=0),
                    np.percentile(post, 97.5, axis=0))
    stack = pdfs.sum(axis=0) / pdfs.sum()
    cover = float(np.mean((emp >= lo) & (emp <= hi)))
    print(f"{len(samples)} samples ({nchains} chains), final lnpost "
          f"{lnps[-1]:.1f}")
    print(f"95% credible-interval coverage of the empirical N(z): "
          f"{100*cover:.0f}%")
    l1_post = np.abs(mean - emp).sum()
    l1_stack = np.abs(stack - emp).sum()
    print(f"L1(post mean, truth) {l1_post:.3f} vs L1(stack, truth) "
          f"{l1_stack:.3f} (stacking is biased)")

    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(8, 5))
        plt.plot(grid, emp, "k-", label="empirical N(z)")
        plt.plot(grid, stack, "C1--", label="stacked PDFs (biased)")
        plt.plot(grid, mean, "C0-", label="population posterior mean")
        plt.fill_between(grid, lo, hi, color="C0", alpha=0.3,
                         label="95% CI")
        plt.xlabel("z")
        plt.ylabel("N(z)")
        plt.legend()
        plt.tight_layout()
        plt.savefig(os.path.join(out, "torch_demo5_population.png"),
                    dpi=100)
        print(f"saved {out}/torch_demo5_population.png")
    return sampler


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="demos/output")
    p.add_argument("--nobs", type=int, default=1000)
    p.add_argument("--niter", type=int, default=200)
    p.add_argument("--device", default="cuda")
    p.add_argument("--no-plot", action="store_true")
    a = p.parse_args()
    main(out=a.out, nobs=a.nobs, niter=a.niter, plot=not a.no_plot,
         device=a.device)
