"""Carry fitter state across from the JAX package.

The state of a `BruteForce` is its model set (photometry, errors, mask),
the full-mask flag and the saved fits of its last `fit` (the
(Ndata, Nmodel) grids, with the free-scale `fit_scale` / `fit_scale_err`
under ``track_scale``); that of a `NearestNeighbors` its model set,
feature ensembles and saved fits; that of a trained `SelfOrganizingMap` or
`GrowingNeuralGas` its model set, nodes and node positions (the GNG's
node errors and edge ages too) and, once populated, its member tables;
the
label side is a `PDFDict` (or a plain grid); that of a sampler its PDFs,
the stored chain and the position it resumes from.
Everything here goes through NumPy: a JAX array exposes ``__array__``,
so `np.asarray` reads it without importing JAX.
"""

from __future__ import annotations

import copy

import numpy as np

__all__ = ["bruteforce_from_arrays", "from_jax_bruteforce", "knn_from_jax",
           "network_from_jax", "pdfdict_from", "sampler_from_jax"]


def bruteforce_from_arrays(models, models_err, models_mask, full_mask=None,
                           device="cuda"):
    """A port `BruteForce` over host (or tensor) model arrays."""
    from ..models.bruteforce import BruteForce

    return BruteForce(models, models_err, models_mask, full_mask=full_mask,
                      device=device)


_SAVED_FITS = ("fit_lnprior", "fit_lnlike", "fit_lnprob", "fit_Ndim",
               "fit_chi2", "fit_scale", "fit_scale_err")


def from_jax_bruteforce(obj, device):
    """Port `BruteForce` with the model set of a `frankenz_tpu` one.

    Reads ``obj.models``, ``obj.models_err``, ``obj.models_mask`` and
    ``obj._full_mask``; dtypes are kept as the JAX object holds them.
    The saved fits (``NDATA`` and the host ``fit_*`` arrays, among them
    ``fit_scale`` / ``fit_scale_err``) are copied where present.
    """
    bf = bruteforce_from_arrays(
        np.asarray(obj.models), np.asarray(obj.models_err),
        np.asarray(obj.models_mask), full_mask=bool(obj._full_mask),
        device=device)
    bf.NDATA = getattr(obj, "NDATA", None)
    for name in _SAVED_FITS:
        value = getattr(obj, name, None)
        if value is not None:
            setattr(bf, name, np.array(value))
    return bf


_KNN_FITS = ("neighbors", "Nneighbors") + _SAVED_FITS


def knn_from_jax(obj, device):
    """Port `NearestNeighbors` holding the state of a `frankenz_tpu` one:
    its model set (dtypes kept), `K`, the feature-map spec, the feature
    ensembles `features` / `features_sqnorm`, a copy of its generator
    (`rng`, so both continue one stream) and, where present, the saved
    fits (`NDATA`, `k`, `neighbors`, `Nneighbors`, `fit_*`).  The port
    object's own ensembles, drawn from a throwaway generator, are
    replaced by JAX's."""
    from ..models.knn import NearestNeighbors

    name, args, kw_items = obj.fmap_spec
    nn = NearestNeighbors(np.asarray(obj.models), np.asarray(obj.models_err),
                          np.asarray(obj.models_mask), K=obj.K,
                          feature_map=name, fmap_args=args,
                          fmap_kwargs=dict(kw_items),
                          rng=np.random.default_rng(0), verbose=False,
                          device=device)
    nn.rng = copy.deepcopy(obj.rng)
    nn.features = nn._tensor(np.asarray(obj.features))
    nn.features_sqnorm = nn._tensor(np.asarray(obj.features_sqnorm))
    nn.NDATA = getattr(obj, "NDATA", None)
    nn.k = getattr(obj, "k", None)
    for name in _KNN_FITS:
        value = getattr(obj, name, None)
        if value is not None:
            setattr(nn, name, np.array(value))
    return nn


_NETWORK_STATE = ("NSIDE", "NNODE", "NPROJ", "NITER", "NBATCH")
_GNG_STATE = ("nodes_err", "edge_ages", "edge_overflow")
_MEMBER_TABLES = ("nodes_idxs", "nodes_logwts", "nodes_scales",
                  "nodes_scales_err", "nodes_bmus", "nodes_Nmatch",
                  "nodes_Nbmu", "models_lmap", "models_levid")


def network_from_jax(obj, device):
    """Port `SelfOrganizingMap` or `GrowingNeuralGas` (whichever class
    `obj` is, by name) holding the state of a trained `frankenz_tpu` one:
    its model set, `nodes`, `nodes_pos`, the lattice sizes or, for a GNG,
    `nodes_err`, `edge_ages` and `edge_overflow`, and, once it has been
    populated, the member tables, `models_lmap` / `models_levid` and the
    `lpnet_*` settings.  The JAX default `lpnet_func` maps to the port's
    default; another function cannot be carried across and raises
    ValueError."""
    from ..models.networks import GrowingNeuralGas, SelfOrganizingMap

    gng = type(obj).__name__ == "GrowingNeuralGas"
    cls = GrowingNeuralGas if gng else SelfOrganizingMap
    net = cls(np.asarray(obj._models_np), np.asarray(obj._models_err_np),
              np.asarray(obj._models_mask_np), device=device)
    net.nodes = np.array(obj.nodes, dtype=float)
    net.nodes_pos = np.array(obj.nodes_pos, dtype=float)
    for name in _GNG_STATE if gng else ():
        value = getattr(obj, name)
        setattr(net, name, np.array(value) if name != "edge_overflow"
                else int(value))
    for name in _NETWORK_STATE:
        if hasattr(obj, name):
            setattr(net, name, getattr(obj, name))
    for name in _MEMBER_TABLES:
        value = getattr(obj, name, None)
        if value is not None:
            setattr(net, name, np.array(value))
    func = getattr(obj, "lpnet_func", None)
    if func is not None and (getattr(func, "__name__", "") != "logprob" or
                             not getattr(func, "__module__", "").endswith(
                                 "ops.likelihood")):
        raise ValueError("only the default lpnet_func (logprob) can be "
                         "carried across, got {!r}".format(func))
    net.lpnet_args = tuple(getattr(obj, "lpnet_args", ()) or ())
    kw = getattr(obj, "lpnet_kwargs", None)
    net.lpnet_kwargs = dict(kw) if kw is not None else None
    return net


def pdfdict_from(obj):
    """Rebuild a port `PDFDict` from any object with `grid`,
    `sigma_grid` and `sigma_trunc` (e.g. a `frankenz_tpu` PDFDict)."""
    from ..ops.kde import PDFDict

    return PDFDict(np.asarray(obj.grid), np.asarray(obj.sigma_grid),
                   sigma_trunc=float(obj.sigma_trunc))


def sampler_from_jax(obj, device):
    """Port `population_sampler` or `hierarchical_sampler` (whichever class
    `obj` is, by name) holding the state of a `frankenz_tpu` one: its
    `pdfs`, the stored `samples` / `samples_lnp` and the chain state, so
    that a chain started there resumes here from the same position and
    `results` holds both parts."""
    from ..samplers import hierarchical_sampler, population_sampler

    cls = (hierarchical_sampler
           if type(obj).__name__ == "hierarchical_sampler"
           else population_sampler)
    samp = cls(np.asarray(obj.pdfs), device=device)
    samp.samples = [np.array(s, dtype=float) for s in obj.samples]
    samp.samples_lnp = [np.array(v, dtype=float) if np.ndim(v) else float(v)
                        for v in obj.samples_lnp]
    state = obj._chain_state
    samp._chain_state = None if state is None else np.array(state,
                                                            dtype=float)
    return samp
