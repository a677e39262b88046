"""MCMC samplers over the population redshift distribution N(z)."""

from .hierarchical import (  # noqa: F401
    dirichlet_logpdf,
    hierarchical_sampler,
    multinomial_logpmf,
)
from .population import loglike_nz, population_sampler  # noqa: F401

__all__ = ["loglike_nz", "population_sampler", "hierarchical_sampler",
           "multinomial_logpmf", "dirichlet_logpdf"]
