"""
Demo 4 on the PyTorch port — Posterior Approximations (the workflow of
`demo4_posterior_approximations.py` on `frankenz_tpu_torch`).

Compares the accelerated fitters — KMCkNN and the SOM manifold fitter —
against exact BruteForce posteriors on the demo-1 mock, every fitter on
`device` (the card by default; the SOM trains there as one `som_train`
launch where it is eligible).

Run after demo 1:  python demos/torch_demo4_posterior_approximations.py
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(out="demos/output", nfit=1000, plot=True, device="cuda"):
    import torch

    from frankenz_tpu_torch.fitting import (BruteForce, NearestNeighbors,
                                            SelfOrganizingMap)
    from frankenz_tpu_torch.ops import pdfs_summarize

    mock = np.load(os.path.join(out, "mock_sdss_cww_bpz.npz"))
    ok = np.isfinite(mock["refmags"]) \
        & np.isfinite(mock["phot_obs"]).all(axis=1)
    idx = np.flatnonzero(ok)[:nfit]
    phot, err = mock["phot_obs"][idx], mock["phot_err"][idx]
    mask = np.ones_like(phot)
    ztrue = mock["redshifts"][idx]
    models, mz = mock["models"], mock["model_z"]
    me = np.zeros_like(models)
    mm = np.ones_like(models)
    zerr = np.full(len(mz), 0.02)
    grid = np.linspace(0.0, 7.0, 701)
    kw = dict(free_scale=True, ignore_model_err=True)

    results = {}
    t0 = time.time()
    bf = BruteForce(models, me, mm, device=device)
    results["bruteforce"] = (bf.fit_predict(
        phot, err, mask, mz, zerr, label_grid=grid, verbose=False,
        lprob_kwargs=kw), time.time() - t0)

    t0 = time.time()
    nn = NearestNeighbors(models, me + 1e-5, mm, K=10, seed=1,
                          verbose=False, device=device)
    results["kmcknn"] = (nn.fit_predict(
        phot, err, mask, mz, zerr, label_grid=grid, k=20, verbose=False,
        lprob_kwargs=kw), time.time() - t0)

    t0 = time.time()
    # The network layer fits the models themselves against the nodes, so
    # the models need nonzero errors (zero variance is degenerate in the
    # reference formulation as well).
    som = SelfOrganizingMap(models, 0.01 * models + 1e-5, mm, device=device)
    som.train_network(nside=20, nproj=2, niter=500, nbatch=50, seed=2,
                      verbose=False)
    som.populate_network(verbose=False)
    results["som nodes"] = (som.fit_predict(
        phot, err, mask, mz, zerr, label_grid=grid, nodes_only=True,
        verbose=False), time.time() - t0)

    ref = results["bruteforce"][0]
    print(f"{'fitter':>11s} {'sigma_MAD':>10s} {'outlier%':>9s} "
          f"{'L1 vs BF':>9s} {'time':>7s}")
    for name, (pdfs, dt) in results.items():
        s = pdfs_summarize(torch.as_tensor(pdfs, device=device), grid)
        zhat = s.median.point.cpu().numpy()
        dz = (zhat - ztrue) / (1 + ztrue)
        smad = 1.4826 * np.median(np.abs(dz - np.median(dz)))
        l1 = np.median(np.abs(pdfs - ref).sum(axis=1))
        print(f"{name:>11s} {smad:10.4f} "
              f"{100*(np.abs(dz) > 0.15).mean():9.1f} {l1:9.3f} "
              f"{dt:6.1f}s")

    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        pick = np.argsort(ztrue)[nfit // 2]
        for name, (pdfs, _) in results.items():
            axes[0].plot(grid, pdfs[pick], label=name)
        axes[0].axvline(ztrue[pick], color="k", ls="--", lw=1)
        axes[0].set(xlabel="z", title=f"object {pick} posterior",
                    xlim=(0, 4))
        axes[0].legend()
        for ax, name in zip(axes[1:], ["kmcknn", "som nodes"]):
            ax.scatter(ref.argmax(1), results[name][0].argmax(1), s=3,
                       alpha=0.3)
            ax.set(xlabel="bruteforce mode bin", ylabel=f"{name} mode bin",
                   title=f"{name} vs exact")
        fig.tight_layout()
        fig.savefig(os.path.join(out, "torch_demo4_approx.png"), dpi=100)
        print(f"saved {out}/torch_demo4_approx.png")
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="demos/output")
    p.add_argument("--nfit", type=int, default=1000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--no-plot", action="store_true")
    a = p.parse_args()
    main(out=a.out, nfit=a.nfit, plot=not a.no_plot, device=a.device)
