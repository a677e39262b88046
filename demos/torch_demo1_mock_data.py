"""
Demo 1 on the PyTorch port — Mock Data (the workflow of
`demo1_mock_data.py` on `frankenz_tpu_torch`).

Builds the SDSS ugriz mock survey with cww+ templates and the BPZ prior,
draws a mock catalog, synthesizes the (z, template, filter) model grid on
`device` (the card by default), and saves everything for the later
demos.

Run:  python demos/torch_demo1_mock_data.py [--nobj 5000] [--out demos/output]
      [--device cuda]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(nobj=5000, out="demos/output", seed=7, plot=True, nz=700,
         device="cuda"):
    from frankenz_tpu_torch.sim import MockSurvey

    os.makedirs(out, exist_ok=True)
    survey = MockSurvey(survey="sdss", templates="cww+", prior="bpz",
                        seed=seed, device=device)
    print(f"filters: {[f['name'] for f in survey.filters]}")
    print(f"templates: {survey.NTEMPLATE} ({survey.NTYPE} types)")

    data = survey.make_mock(nobj, verbose=False)
    ok = np.isfinite(data["refmags"])
    print(f"mock catalog: {nobj} objects ({ok.sum()} with good photometry)")

    zgrid = np.linspace(0.0, 7.0, nz + 1)[1:]
    survey.make_model_grid(zgrid, verbose=False)
    flat, zz, tt = survey.flatten_grid()
    print(f"model grid: {survey.models['data'].shape} -> {flat.shape}")

    np.savez(os.path.join(out, "mock_sdss_cww_bpz.npz"),
             phot_obs=data["phot_obs"], phot_err=data["phot_err"],
             phot_true=data["phot_true"], refmags=data["refmags"],
             redshifts=data["redshifts"], templates=data["templates"],
             types=data["types"], models=flat, model_z=zz, model_t=tt,
             depths=[f["depth_flux1sig"] for f in survey.filters])
    print(f"saved {out}/mock_sdss_cww_bpz.npz")

    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        for f in survey.filters:
            axes[0].plot(f["wavelength"], f["transmission"],
                         label=f["name"])
        axes[0].set(xlabel="wavelength [A]", ylabel="transmission",
                    title="SDSS filters")
        axes[0].legend()
        axes[1].hist(data["redshifts"][ok], bins=50, histtype="step")
        axes[1].set(xlabel="redshift", title="mock N(z)")
        with np.errstate(all="ignore"):
            gr = -2.5 * np.log10(data["phot_true"][ok, 1]
                                 / data["phot_true"][ok, 2])
        axes[2].scatter(data["redshifts"][ok], gr, s=2, alpha=0.2)
        axes[2].set(xlabel="redshift", ylabel="g-r",
                    title="color-redshift", ylim=(-1, 3))
        fig.tight_layout()
        fig.savefig(os.path.join(out, "torch_demo1_mock.png"), dpi=100)
        print(f"saved {out}/torch_demo1_mock.png")
    return data, survey


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--nobj", type=int, default=5000)
    p.add_argument("--out", default="demos/output")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda")
    p.add_argument("--no-plot", action="store_true")
    a = p.parse_args()
    main(nobj=a.nobj, out=a.out, seed=a.seed, plot=not a.no_plot,
         device=a.device)
