"""
frankenz_tpu_torch: the PyTorch + CUDA port of `frankenz_tpu`.

Same layout as the JAX package, so each module's counterpart is easy to
find:
  ops/      likelihood, KDE, summaries, photometry transforms and the
            fused fit -> PDF route;
  models/   fitters: BruteForce, NearestNeighbors, SelfOrganizingMap,
            GrowingNeuralGas;
  samplers/ population and hierarchical N(z) MCMC over the fitters' PDFs;
  parallel/ device meshes (`Mesh`, `Sharded`), the object-sharded,
            model-sharded and ring fit steps, the stacked N(z), and the
            multi-process runtime (`torch.distributed`, NCCL or gloo) with
            its catalog input; every fitter's and sampler's `mesh=`;
  sim/      mock-survey simulator: priors, IGM attenuation, flux synthesis
            on the card, the SDSS-like mock catalog and model grid;
  kernels/  ctypes wrappers of the hand-written CUDA kernels, their plain
            PyTorch versions and launch counters;
  csrc/     the CUDA C++ sources (built with nvcc at first use);
  utils/    checkpoints (npz), metrics, progress, torch.profiler tracing,
            and state conversion from the JAX package;
  config    dataclasses of the reference's defaults;
  plotting  diagnostics (the preparation in torch, matplotlib only to
            draw).

The package imports torch, numpy and scipy only; it never imports JAX or
`frankenz_tpu` (the simulator reads the JAX package's filter and SED
files by path).
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from . import ops  # noqa: F401
from . import models  # noqa: F401
from . import fitting  # noqa: F401
from . import samplers  # noqa: F401
from . import parallel  # noqa: F401
from . import sim  # noqa: F401
from . import utils  # noqa: F401
from . import plotting  # noqa: F401
from .models import (BruteForce, GrowingNeuralGas,  # noqa: F401
                     NearestNeighbors, SelfOrganizingMap)
from .ops.fused import FusedCdfFallback  # noqa: F401
