"""
Checkpoint / resume for fitter, network and sampler state (port of
`frankenz_tpu.utils.checkpoint`).

Every stateful object exposes its state as a flat dict of NumPy arrays
and scalars under the JAX package's names (`_STATE_ATTRS`, per class
name, read through the MRO), so a checkpoint of one package is read by
the other.  The format is NumPy ``.npz`` only: `save` writes one file,
`restore` reads it with ``allow_pickle=False``.  The JAX package may
also write Orbax directories; the port does not (``use_orbax=True``
raises ValueError, and so does `restore` of a directory).

Batch-granular resume: the fitters' `fit` loops write into preallocated
host arrays, so a checkpoint taken between batches holds a consistent
prefix (`_fit_rows_done` rows); the training runs save their carried
state between segments; samplers resume from their stored
`_chain_state`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["state_dict", "load_state_dict", "save", "restore", "exists",
           "validate_plan"]

# Attributes that constitute persistent state, per class name (the JAX
# package's schema, frankenz_tpu/utils/checkpoint.py:27-47).
_STATE_ATTRS = {
    "BruteForce": ["fit_lnprior", "fit_lnlike", "fit_lnprob", "fit_Ndim",
                   "fit_chi2", "fit_scale", "fit_scale_err", "NDATA",
                   "_fit_rows_done"],
    "NearestNeighbors": ["fit_lnprior", "fit_lnlike", "fit_lnprob",
                         "fit_Ndim", "fit_chi2", "fit_scale",
                         "fit_scale_err", "neighbors", "Nneighbors",
                         "NDATA", "k", "features", "_fit_rows_done"],
    "_Network": ["nodes", "nodes_pos", "nodes_idxs", "nodes_logwts",
                 "nodes_scales", "nodes_scales_err", "nodes_bmus",
                 "nodes_Nmatch", "nodes_Nbmu", "nodes_only", "models_lmap",
                 "models_levid", "neighbors", "Nneighbors", "fit_lnprior",
                 "fit_lnlike", "fit_lnprob", "fit_Ndim", "fit_chi2",
                 "fit_scale", "fit_scale_err", "NNODE", "NPROJ", "NDATA",
                 "_fit_rows_done"],
    "population_sampler": ["samples", "samples_lnp", "_chain_state"],
    "hierarchical_sampler": ["samples", "samples_lnp", "_chain_state"],
}
_STATE_ATTRS["SelfOrganizingMap"] = _STATE_ATTRS["_Network"] + ["NSIDE"]
_STATE_ATTRS["GrowingNeuralGas"] = _STATE_ATTRS["_Network"] + [
    "nodes_err", "edge_ages"]

# Attributes of the schema that the port keeps as tensors on the object's
# `device` (every other one is a host array or a scalar, as in JAX).
_TENSOR_ATTRS = {"NearestNeighbors": {"features"}}


def _lookup(table, obj, default):
    for klass in type(obj).__mro__:
        if klass.__name__ in table:
            return table[klass.__name__]
    return default


def _attrs_for(obj):
    attrs = _lookup(_STATE_ATTRS, obj, None)
    if attrs is None:
        raise TypeError("no checkpoint schema for {}".format(type(obj)))
    return attrs


def state_dict(obj):
    """An object's persistent state as {name: array-or-scalar}; tensors on
    any device come back as NumPy arrays."""
    out = {}
    for name in _attrs_for(obj):
        val = getattr(obj, name, None)
        if val is None:
            continue
        if isinstance(val, torch.Tensor):
            val = val.detach().cpu().numpy()
        elif isinstance(val, list):
            val = np.asarray(val)
        out[name] = val
    return out


def load_state_dict(obj, state):
    """Restore state produced by `state_dict` (of either package) onto
    `obj` in place, each attribute in the type the port keeps it in."""
    list_attrs = {"samples", "samples_lnp"}
    tensors = _lookup(_TENSOR_ATTRS, obj, set())
    for name, val in state.items():
        val = np.asarray(val)
        if name in list_attrs:
            setattr(obj, name, list(val))
        elif name in tensors:
            setattr(obj, name, torch.tensor(val, device=obj.device))
        elif val.ndim == 0:
            setattr(obj, name, val.item())
        else:
            setattr(obj, name, val)
    if "features" in tensors and "features" in state:
        # The search reads the squared norms beside the features.
        obj.features_sqnorm = (obj.features ** 2).sum(dim=-1)
    return obj


def validate_plan(checkpoint_every, checkpoint_file):
    """Fail fast on an unusable checkpoint request.

    Called at the entry of every loop that honours `checkpoint_every`:
    without it, a missing `checkpoint_file` would surface only at the
    first save, after the batches the checkpoint was meant to protect.
    """
    if checkpoint_every:
        if not checkpoint_file:
            raise ValueError("checkpoint_every requires checkpoint_file")
        if int(checkpoint_every) < 1:
            raise ValueError(
                "checkpoint_every must be a positive batch count")


def _npz_name(path):
    return path if path.endswith(".npz") else path + ".npz"


def save(path, obj_or_state, use_orbax=None):
    """Checkpoint an object (or a raw state dict) to `path` as one ``.npz``
    file (``.npz`` is appended when missing); returns `path`.

    `use_orbax` is kept for the JAX package's signature: None and False
    write npz, True raises ValueError (the port writes npz only).
    """
    if use_orbax:
        raise ValueError("the port writes .npz checkpoints only "
                         "(use_orbax=True needs the JAX package's Orbax "
                         "directories)")
    state = (obj_or_state if isinstance(obj_or_state, dict)
             else state_dict(obj_or_state))
    state = {k: v for k, v in state.items() if v is not None}
    np.savez(_npz_name(path), **state)
    return path


def restore(path, obj=None):
    """Load a ``.npz`` checkpoint (the port's, or one the JAX package wrote
    with ``use_orbax=False``); with `obj`, restore onto it in place and
    return it, else return the state dict."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an Orbax checkpoint of the "
                         "JAX package?); the port reads .npz checkpoints "
                         "only")
    with np.load(_npz_name(path), allow_pickle=False) as f:
        state = {k: f[k] for k in f.files}
    if obj is not None:
        return load_state_dict(obj, state)
    return state


def exists(path):
    """True if `path` holds a checkpoint written by `save` (or an Orbax
    directory of the JAX package, which `restore` refuses)."""
    return (os.path.isdir(path) or os.path.exists(path)
            or os.path.exists(path + ".npz"))
