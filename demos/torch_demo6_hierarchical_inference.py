"""
Demo 6 on the PyTorch port — Hierarchical Inference (the workflow of
`demo6_hierarchical_inference.py` on `frankenz_tpu_torch`).

Collapsed-Gibbs hierarchical sampling over per-object redshift
*likelihoods* with a Dirichlet hyper-prior, with and without an
unrepresentative reference sample, on `device` (the card by default).

Run:  python demos/torch_demo6_hierarchical_inference.py
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_demo5_population_inference import make_mock_pdfs  # noqa: E402


def main(out="demos/output", nobs=1000, niter=400, plot=True,
         device="cuda"):
    from frankenz_tpu_torch.samplers import hierarchical_sampler

    os.makedirs(out, exist_ok=True)
    grid, nz_true, ztrue, pdfs = make_mock_pdfs(nobs=nobs, seed=11)
    emp = np.bincount(ztrue, minlength=len(grid)) / nobs

    sampler = hierarchical_sampler(pdfs, device=device)
    sampler.run_mcmc(niter, thin=5, seed=4, nchains=2, verbose=False)
    samples, lnps = sampler.results
    burn = len(samples) // 2
    post = samples[burn:]
    mean = post.mean(axis=0)
    lo, hi = np.percentile(post, [2.5, 97.5], axis=0)
    cover = float(np.mean((emp >= lo) & (emp <= hi)))
    print(f"hierarchical: {len(samples)} samples, 95% CI coverage "
          f"{100*cover:.0f}%")

    # With a reference sample drawn from the same N(z).
    rng = np.random.default_rng(12)
    ref = rng.multinomial(500, nz_true).astype(float)
    sampler_ref = hierarchical_sampler(pdfs, device=device)
    sampler_ref.run_mcmc(niter, thin=5, seed=5, ref_sample=ref,
                         verbose=False)
    samples_ref, _ = sampler_ref.results
    # Burn-in sized to this run (one chain, half the samples of the
    # two-chain run above).
    burn_ref = len(samples_ref) // 2
    mean_ref = samples_ref[burn_ref:].mean(axis=0)
    l1_ref = float(np.abs(mean_ref - emp).sum())
    l1_noref = float(np.abs(mean - emp).sum())
    print(f"with reference sample: L1 to empirical {l1_ref:.3f} vs "
          f"{l1_noref:.3f} without")
    if not (np.isfinite(l1_ref) and np.isfinite(l1_noref)):
        raise RuntimeError("the reference comparison is not finite")

    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(8, 5))
        plt.plot(grid, emp, "k-", label="empirical N(z)")
        plt.plot(grid, mean, "C0-", label="hierarchical posterior")
        plt.fill_between(grid, lo, hi, color="C0", alpha=0.3)
        plt.plot(grid, mean_ref, "C2--", label="+ reference sample")
        plt.xlabel("z")
        plt.ylabel("N(z)")
        plt.legend()
        plt.tight_layout()
        plt.savefig(os.path.join(out, "torch_demo6_hierarchical.png"),
                    dpi=100)
        print(f"saved {out}/torch_demo6_hierarchical.png")
    return sampler


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="demos/output")
    p.add_argument("--nobs", type=int, default=1000)
    p.add_argument("--niter", type=int, default=400)
    p.add_argument("--device", default="cuda")
    p.add_argument("--no-plot", action="store_true")
    a = p.parse_args()
    main(out=a.out, nobs=a.nobs, niter=a.niter, plot=not a.no_plot,
         device=a.device)
