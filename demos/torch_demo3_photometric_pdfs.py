"""
Demo 3 on the PyTorch port — Photometric PDFs (the workflow of
`demo3_photometric_pdfs.py` on `frankenz_tpu_torch`).

Full-PDF validation of the demo-1 mock: stacked PDFs vs the true N(z),
point-estimate quality from `pdfs_summarize`, and the coverage tests
(`cdf_vs_epdf` / `cdf_vs_ecdf`), with the fit, the summaries and the
coverage statistics on `device` (the card by default).

Run after demo 1:  python demos/torch_demo3_photometric_pdfs.py
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(out="demos/output", nfit=3000, plot=True, device="cuda"):
    import torch

    from frankenz_tpu_torch import plotting as fzplot
    from frankenz_tpu_torch.fitting import BruteForce
    from frankenz_tpu_torch.ops import PDFDict, pdfs_summarize

    mock = np.load(os.path.join(out, "mock_sdss_cww_bpz.npz"))
    ok = np.isfinite(mock["refmags"]) \
        & np.isfinite(mock["phot_obs"]).all(axis=1)
    idx = np.flatnonzero(ok)[:nfit]
    phot, err = mock["phot_obs"][idx], mock["phot_err"][idx]
    ztrue = mock["redshifts"][idx]
    models, mz = mock["models"], mock["model_z"]

    grid = np.linspace(0.0, 7.0, 701)
    vdict = PDFDict(grid, np.linspace(0.005, 0.5, 100))
    bf = BruteForce(models, np.zeros_like(models), np.ones_like(models),
                    device=device)
    pdfs, (lmap, levid) = bf.fit_predict(
        phot, err, np.ones_like(phot), mz, np.full(len(mz), 0.02),
        label_dict=vdict, return_gof=True, verbose=False,
        lprob_kwargs=dict(free_scale=True, ignore_model_err=True))
    pdfs_dev = torch.as_tensor(pdfs, device=device)
    s = pdfs_summarize(pdfs_dev, grid)
    zhat = s.median.point.cpu().numpy()
    dz = (zhat - ztrue) / (1 + ztrue)
    print(f"sigma_MAD: {1.4826*np.median(np.abs(dz - np.median(dz))):.4f}")
    print(f"outliers |dz|>0.15: {100*(np.abs(dz) > 0.15).mean():.1f}%")

    # Stacked N(z) vs truth.
    nz_stack = pdfs.sum(axis=0)
    nz_stack /= np.trapezoid(nz_stack, grid)

    # Coverage: CDF draws at jittered truths should be ~Uniform(0, 1).
    n = fzplot.cdf_vs_epdf(ztrue, np.full_like(ztrue, 1e-4), pdfs_dev, grid,
                           Nmc=20, seed=1, plot=False)
    flatness = n.std() / n.mean()
    print(f"coverage histogram mean {n.mean():.3f}, rel std "
          f"{flatness:.3f} (0 = perfectly calibrated)")

    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 2, figsize=(11, 8))
        axes[0, 0].hist(ztrue, bins=70, density=True, histtype="step",
                        label="true N(z)")
        axes[0, 0].plot(grid, nz_stack, label="stacked PDFs")
        axes[0, 0].set(xlabel="z", title="stacked PDFs vs truth")
        axes[0, 0].legend()
        plt.sca(axes[0, 1])
        fzplot.input_vs_pdf(ztrue, np.full_like(ztrue, 0.02), vdict,
                            pdfs_dev, grid)
        axes[0, 1].set(xlim=(0, 6), ylim=(0, 6),
                       title="truth vs PDF stack")
        plt.sca(axes[1, 0])
        fzplot.cdf_vs_epdf(ztrue, np.full_like(ztrue, 1e-4), pdfs_dev, grid,
                           Nmc=20, seed=1)
        axes[1, 0].set_title("coverage (PDF)")
        plt.sca(axes[1, 1])
        fzplot.cdf_vs_ecdf(ztrue, np.full_like(ztrue, 1e-4), pdfs_dev, grid,
                           Nmc=20, seed=2)
        axes[1, 1].plot([0, 1], [0, 1], "k--", lw=1)
        axes[1, 1].set_title("coverage (CDF)")
        fig.tight_layout()
        fig.savefig(os.path.join(out, "torch_demo3_pdfs.png"), dpi=100)
        print(f"saved {out}/torch_demo3_pdfs.png")
    return pdfs, s


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="demos/output")
    p.add_argument("--nfit", type=int, default=3000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--no-plot", action="store_true")
    a = p.parse_args()
    main(out=a.out, nfit=a.nfit, plot=not a.no_plot, device=a.device)
