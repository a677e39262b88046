"""
frankenz_tpu_torch: the PyTorch + CUDA port of `frankenz_tpu`.

Same layout as the JAX package, so each module's counterpart is easy to
find:
  ops/      likelihood, KDE, summaries and the fused fit -> PDF route;
  models/   fitters: BruteForce, SelfOrganizingMap, GrowingNeuralGas;
  samplers/ population and hierarchical N(z) MCMC over the fitters' PDFs;
  kernels/  ctypes wrappers of the hand-written CUDA kernels, their plain
            PyTorch versions and launch counters;
  csrc/     the CUDA C++ sources (built with nvcc at first use);
  utils/    metrics, progress, and state conversion from the JAX package.

The package imports torch, numpy and scipy only; it never imports JAX or
`frankenz_tpu`.
"""

__version__ = "0.1.0"

from . import ops  # noqa: F401
from . import models  # noqa: F401
from . import fitting  # noqa: F401
from . import samplers  # noqa: F401
from . import utils  # noqa: F401
from .models import (BruteForce, GrowingNeuralGas,  # noqa: F401
                     SelfOrganizingMap)
from .ops.fused import FusedCdfFallback  # noqa: F401
