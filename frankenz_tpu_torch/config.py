"""
Dataclass configuration with the reference's embedded defaults (port of
`frankenz_tpu.config`).

The reference keeps every default inline in its function signatures
(`wt_thresh=1e-3`, `cdf_thresh=2e-4`, kNN `K=25` / `k=20`, the SOM and
GNG hyper-parameters).  These frozen dataclasses collect them in one
place; the fitters take plain keyword arguments as before, and
``.asdict()`` splats a configuration into any call.  Each default is the
default of the port's own parameter of the same name.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = ["ThresholdConfig", "LikelihoodConfig", "KNNConfig", "SOMConfig",
           "GNGConfig", "PopulationSamplerConfig",
           "HierarchicalSamplerConfig", "BatchConfig"]


class _AsDict:
    def asdict(self):
        return dataclasses.asdict(self)

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


@dataclass(frozen=True)
class ThresholdConfig(_AsDict):
    """Weight-thresholding defaults (the fitters' `predict` /
    `fit_predict`, reference pdf.py:508-516)."""

    wt_thresh: float | None = 1e-3
    cdf_thresh: float | None = 2e-4


@dataclass(frozen=True)
class LikelihoodConfig(_AsDict):
    """`ops.loglike` / `ops.logprob` flags (pdf.py:238-323)."""

    free_scale: bool = False
    ignore_model_err: bool = False
    dim_prior: bool = True
    ltol: float = 1e-4
    return_scale: bool = False


@dataclass(frozen=True)
class KNNConfig(_AsDict):
    """NearestNeighbors defaults: `K`, `feature_map` and `leafsize` of the
    constructor, `k` and `lp_norm` of `fit` (knn.py:40, :190)."""

    K: int = 25
    k: int = 20
    feature_map: str = "luptitude"
    lp_norm: int = 2
    leafsize: int = 50  # accepted for API parity; no trees are built


@dataclass(frozen=True)
class SOMConfig(_AsDict):
    """`SelfOrganizingMap.train_network` defaults (networks.py:1517-1519)."""

    nside: int = 50
    nproj: int = 2
    niter: int = 2000
    nbatch: int = 50
    wt_thresh: float | None = 1e-3
    cdf_thresh: float | None = 2e-4
    track_scale: bool = False


@dataclass(frozen=True)
class GNGConfig(_AsDict):
    """`GrowingNeuralGas.train_network` defaults (networks.py:1898-1902)."""

    niter: int = 5000
    nbatch: int = 50
    max_nodes: int = 2500
    max_age: int = 15
    learn_best: float = 0.2
    learn_neighbor: float = 0.005
    new_err_dec: float = 0.5
    all_err_dec: float = 0.005
    track_scale: bool = False


@dataclass(frozen=True)
class PopulationSamplerConfig(_AsDict):
    """`population_sampler.run_mcmc` defaults (samplers.py:118-120)."""

    thin: int = 400
    mh_steps: int = 3
    nchains: int = 1


@dataclass(frozen=True)
class HierarchicalSamplerConfig(_AsDict):
    """`hierarchical_sampler.run_mcmc` defaults (samplers.py:349-351)."""

    thin: int = 5
    nchains: int = 1


@dataclass(frozen=True)
class BatchConfig(_AsDict):
    """The port's batching knobs (no reference counterpart).

    `batch_size` is the fitters' object batch (None: sized from the
    model count, or on the fused route from the PDF width);
    `grid_budget_elems` the (B, M) grid that sizes the plain route's
    batch (`models.bruteforce.default_batch_size`'s `budget_elems`);
    `synth_budget_bytes` the card memory of one flux-synthesis chunk
    (`sim.MockSurvey.synthesize_grid`'s `budget_bytes`).
    """

    batch_size: int | None = None
    grid_budget_elems: int = 1 << 26
    synth_budget_bytes: int = 1 << 28
