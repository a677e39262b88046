"""The one generator: a deployment's models, labels and catalog chunks
from ``--seed``, as the configuration and the traffic file set them.

The photometry is a mock survey's (`survey.Survey`: the configuration's
filters, templates and prior).  Models are either a training set, a mock
catalog of its own with its redshifts as labels (``"kind": "mock"``), or
a grid of templates over redshift (``"template_grid"``: the listed
templates and ``interp`` mixtures between each neighbouring pair, at
``n / templates`` redshifts).  Catalog chunks are mock catalogs.  Every
draw is made on the device with a `torch.Generator` in a few large
calls, so a seed gives the same inputs on one kind of device.  The
catalog chunks then go to the host: the fitter takes host arrays, as a
survey pipeline reads them from disk.
"""

from __future__ import annotations

import numpy as np
import torch

from .spec import ROOT
from .survey import Survey

# Independent streams of one seed: the models, the rows the output check
# samples, and each chunk (from 3 on).
_MODELS, _SAMPLE, _CHUNK0 = 0, 2, 3


def stream_seed(seed, stream):
    """A 63-bit seed for `stream` of run seed `seed` (any size)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(stream)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed, stream, device):
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


class Deployment:
    """The inputs of one run: models on `device`, labels and the grid on
    the host, and `chunks` catalog chunks of host arrays."""

    def __init__(self, config, traffic, seed, device, root=ROOT):
        mc, gc = config["models"], config["grid"]
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.survey = sv = Survey(config, self.device, root)
        n = int(mc["n"])
        if mc["kind"] == "mock":
            g = generator(seed, _MODELS, device)
            mag, tmpl, z = sv.draw(g, n, mc["mag"], mc["z"])
            flux, err = sv.observe(g, sv.at_mag(sv.fluxes(tmpl, z), mag))
        elif mc["kind"] == "template_grid":
            step = int(mc["interp"]) + 1
            nt = (sv.ntemplates - 1) * step + 1
            if n % nt:
                raise ValueError(f"{n} models are no grid of {nt} templates")
            k = torch.arange(nt, device=self.device).repeat(n // nt)
            z = torch.linspace(*mc["z"], n // nt, dtype=torch.float64,
                               device=self.device).repeat_interleave(nt)
            flux = sv.fluxes(k // step, z, (k % step).double() / step)
            flux = sv.at_mag(flux, torch.full_like(z, float(mc["ref_mag"])))
            err = float(mc["err_frac"]) * flux
        else:
            raise ValueError(f"unknown models kind {mc['kind']!r}")
        self.models = flux.float()
        self.models_err = err.float().contiguous()
        self.models_mask = torch.ones_like(self.models)
        self.labels = z.cpu().numpy()
        self.label_errs = np.full(n, float(mc["label_err"]))
        self.grid = np.linspace(gc["lo"], gc["hi"], int(gc["n"]))
        self.sigmas = np.linspace(gc["sigma_lo"], gc["sigma_hi"],
                                  int(gc["sigma_n"]))
        self.sigma_trunc = float(gc["sigma_trunc"])
        self.chunks = [self.chunk(k) for k in range(int(traffic["chunks"]))]

    def chunk(self, k):
        """Catalog chunk `k`: (data, data_err, data_mask) host float32
        arrays of ``objects_per_call`` rows."""
        cc, tr, sv = self.config["catalog"], self.traffic, self.survey
        n, f = int(tr["objects_per_call"]), self.models.shape[1]
        dev = self.device
        g = generator(self.seed, _CHUNK0 + k, dev)
        if cc["kind"] != "mock":
            raise ValueError(f"unknown catalog kind {cc['kind']!r}")
        mag, tmpl, z = sv.draw(g, n, cc["mag"], cc["z"])
        data, err = sv.observe(g, sv.at_mag(sv.fluxes(tmpl, z), mag))
        p = float(tr.get("p_missing", 0.0))
        mask = (torch.ones((n, f), device=dev) if p == 0.0 else
                (torch.rand((n, f), generator=g, device=dev) >= p).float())
        return tuple(t.float().cpu().numpy() for t in (data, err, mask))

    def model_arrays(self):
        return self.models, self.models_err, self.models_mask


def sample_keys(seed, call, n):
    """Keys of call `call`'s `n` rows: the output check keeps the rows of
    the window with the smallest keys, a uniform sample of every answer
    the window returned, whatever the number of calls."""
    rng = np.random.default_rng([stream_seed(seed, _SAMPLE), int(call)])
    return rng.random(n, dtype=np.float32)
