"""
Demo 2 on the PyTorch port — Photometric Inference (the workflow of
`demo2_photometric_inference.py` on `frankenz_tpu_torch`).

Fits the demo-1 mock with BruteForce under different likelihoods —
magnitude (fixed scale) vs color (free scale) — and demonstrates the
`lprob_func` plugin hook by adding the explicit BPZ prior to the grid
likelihood (the notebook's `lprob_bpz`).  The fits run on `device` (the
card by default).

Run after demo 1:  python demos/torch_demo2_photometric_inference.py
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bpz_prior_grid(model_z, model_t, type_of_template, mags):
    """ln BPZ prior P(z, t | m) for every (object, model) pair, from the
    port's BPZ tables (`sim.priors.BPZPrior`); `mags` are the objects'
    reference magnitudes.  Returns the (Nobj, Nmodel) ln-prior."""
    from frankenz_tpu_torch.sim.priors import BPZPrior

    prior = BPZPrior.instance()
    nobj = len(mags)
    types = type_of_template  # (Nmodel,) BPZ class of each template
    lnp = np.zeros((nobj, len(model_z)))
    for t in np.unique(types):
        sel = types == t
        # P(z | t, m) on each model's z for all objects, times P(t | m).
        pz = prior.pz_tm(model_z[None, sel], t,
                         np.asarray(mags)[:, None])  # (Nobj, Nsel)
        pt = prior.pt_m(t, np.asarray(mags))[:, None]
        with np.errstate(divide="ignore"):
            lnp[:, sel] = np.log(pz * pt)
    return lnp


def point_estimates(pdfs, grid, device):
    """Median point estimates of host PDFs, summarized on `device`."""
    import torch

    from frankenz_tpu_torch.ops import pdfs_summarize

    s = pdfs_summarize(torch.as_tensor(pdfs, device=device), grid)
    return s.median.point.cpu().numpy()


def main(out="demos/output", nfit=2000, plot=True, device="cuda"):
    import torch

    from frankenz_tpu_torch.fitting import BruteForce
    from frankenz_tpu_torch.ops import logprob
    from frankenz_tpu_torch.ops.transforms import magnitude

    mock = np.load(os.path.join(out, "mock_sdss_cww_bpz.npz"))
    ok = np.isfinite(mock["refmags"]) \
        & np.isfinite(mock["phot_obs"]).all(axis=1)
    idx = np.flatnonzero(ok)[:nfit]
    phot = mock["phot_obs"][idx]
    err = mock["phot_err"][idx]
    mask = np.ones_like(phot)
    ztrue = mock["redshifts"][idx]
    models = mock["models"]
    mz = mock["model_z"]
    mt = mock["model_t"]

    bf = BruteForce(models, np.zeros_like(models), np.ones_like(models),
                    device=device)
    grid = np.linspace(0.0, 7.0, 701)
    zerr = np.full(len(mz), 0.02)

    results = {}
    # (a) magnitude likelihood: fixed scale.
    results["mag"] = bf.fit_predict(
        phot, err, mask, mz, zerr, label_grid=grid, verbose=False,
        lprob_kwargs=dict(free_scale=False, ignore_model_err=True))
    # (b) color likelihood: free scale.
    results["color"] = bf.fit_predict(
        phot, err, mask, mz, zerr, label_grid=grid, verbose=False,
        lprob_kwargs=dict(free_scale=True, ignore_model_err=True))

    # (c) color likelihood + explicit BPZ prior via the lprob hook.
    with np.errstate(all="ignore"):
        refmag = magnitude(phot[:, 2:3], err[:, 2:3],
                           device=device)[0][:, 0].cpu().numpy() + 23.9
    # Noisy fluxes can scatter negative; give those objects the faint
    # limit so the prior stays finite.
    refmag = np.where(np.isfinite(refmag), refmag, 28.0)
    # Map template index -> BPZ broad class via equal split (cww+: E, Sbc,
    # Scd + starbursts -> Irr), as the notebook does.
    t_class = np.clip(mt, 0, 2).astype(int)
    lnprior = bpz_prior_grid(mz, t_class, t_class, refmag)
    lnprior = np.where(np.isfinite(lnprior), lnprior, -np.inf)
    lnprior_t = torch.as_tensor(lnprior, dtype=torch.float32,
                                device=device)

    def lprob_bpz(d, de, dm, m, me, mm):
        res = logprob(d, de, dm, m, me, mm, free_scale=True,
                      ignore_model_err=True)
        lnp = lnprior_t.to(res.lnlike.dtype)
        return (lnp, res.lnlike, res.lnlike + lnp, res.ndim, res.chi2)

    results["color+bpz"] = bf.fit_predict(
        phot, err, mask, mz, zerr, label_grid=grid, verbose=False,
        lprob_func=lprob_bpz, batch_size=len(phot))

    print(f"{'likelihood':>12s} {'sigma_MAD':>10s} {'outlier%':>9s}")
    for name, pdfs in results.items():
        zhat = point_estimates(pdfs, grid, device)
        dz = (zhat - ztrue) / (1 + ztrue)
        smad = 1.4826 * np.median(np.abs(dz - np.median(dz)))
        print(f"{name:>12s} {smad:10.4f} {100*(np.abs(dz) > 0.15).mean():9.1f}")

    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(15, 4.5), sharey=True)
        for ax, (name, pdfs) in zip(axes, results.items()):
            ax.scatter(ztrue, point_estimates(pdfs, grid, device), s=3,
                       alpha=0.3)
            ax.plot([0, 7], [0, 7], "k--", lw=1)
            ax.set(xlim=(0, 6), ylim=(0, 6), xlabel="true z", title=name)
        axes[0].set_ylabel("photo-z (median)")
        fig.tight_layout()
        fig.savefig(os.path.join(out, "torch_demo2_inference.png"), dpi=100)
        print(f"saved {out}/torch_demo2_inference.png")
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="demos/output")
    p.add_argument("--nfit", type=int, default=2000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--no-plot", action="store_true")
    a = p.parse_args()
    main(out=a.out, nfit=a.nfit, plot=not a.no_plot, device=a.device)
