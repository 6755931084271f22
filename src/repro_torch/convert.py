"""Carry the JAX reference's state into the port and back, as numpy arrays.

The port never imports ``jax``; a caller holding the reference's arrays
passes them here as numpy (``np.asarray(x)``, and for a key
``np.asarray(jax.random.key_data(k))``).  What crosses:

* a φ snapshot (:func:`snapshot_from_reference`) and keys
  (:func:`key_from_reference`);
* the serial chain state, ``LDAState`` with its key as ``key_data``
  (:func:`state_from_reference`, :func:`state_to_reference`);
* the ``NomadLDA.init_arrays``/``sweep`` dict (:func:`nomad_arrays_from_
  reference`, :func:`nomad_arrays_to_reference`), of every layout: the
  dense grid, the ragged streams with ``cell_of_tile``, and a grouped
  layout's ``tok_slot`` and ``doc_tile_of``.  The reference keeps
  ``tok_valid``/``tok_bound`` as bool; the port as 0/1 int32;
* the Table 1 sampler states (``core/samplers.py``: LSearch, BSearch,
  Alias, F+tree) as a dict of their fields
  (:func:`sampler_state_from_reference`, :func:`sampler_state_to_reference`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch._device import resolve
from repro_torch.core import samplers
from repro_torch.core.cgs import (LDAState, state_from_checkpoint,
                                 state_to_checkpoint)
from repro_torch.serve.lda_engine import PhiSnapshot

__all__ = ["snapshot_from_reference", "key_from_reference",
           "state_from_reference", "state_to_reference",
           "nomad_arrays_from_reference", "nomad_arrays_to_reference",
           "sampler_state_from_reference", "sampler_state_to_reference",
           "SAMPLER_STATES"]

_BOOL_FIELDS = ("tok_valid", "tok_bound")

#: Each sampler's state type, under its ``SAMPLERS`` name.
SAMPLER_STATES = {"lsearch": samplers.LSearchState,
                  "bsearch": samplers.BSearchState,
                  "alias": samplers.AliasState,
                  "ftree": samplers.FTreeState}


def snapshot_from_reference(phi: np.ndarray, meta: dict) -> PhiSnapshot:
    """A port snapshot from a reference ``PhiSnapshot``'s table and meta.
    The digest travels in ``meta``; ``LdaEngine.publish`` verifies it."""
    return PhiSnapshot(phi=np.asarray(phi, np.float32), meta=dict(meta))


def key_from_reference(key_data: np.ndarray, device=None) -> torch.Tensor:
    """A port key (or batch of keys) from ``jax.random.key_data(k)``."""
    return rng.wrap_key_data(key_data, device)


def state_from_reference(z, n_td, n_wt, n_t, key_data,
                         device=None) -> LDAState:
    """The port's ``LDAState`` from the reference's fields, as numpy."""
    return state_from_checkpoint(dict(z=z, n_td=n_td, n_wt=n_wt, n_t=n_t,
                                      key_data=key_data), device)


def state_to_reference(state: LDAState) -> dict:
    """``{z, n_td, n_wt, n_t, key_data}`` as numpy, for
    ``LDAState(..., key=jax.random.wrap_key_data(key_data))``."""
    return state_to_checkpoint(state)


def nomad_arrays_from_reference(arrays: dict, device=None) -> dict:
    """The port's ``NomadLDA`` arrays from the reference's dict (numpy
    values): every array as a contiguous int32 tensor on ``device``."""
    dev = resolve(device)
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.int32),
                               device=dev) for k, v in arrays.items()}


def nomad_arrays_to_reference(arrays: dict) -> dict:
    """The reference's ``NomadLDA`` dict (numpy values) from the port's:
    int32 arrays, with ``tok_valid``/``tok_bound`` back to bool."""
    out = {k: v.cpu().numpy() for k, v in arrays.items()}
    for k in _BOOL_FIELDS:
        if k in out:
            out[k] = out[k].astype(bool)
    return out


def sampler_state_from_reference(name: str, fields: dict,
                                 device=None) -> tuple:
    """The port's state of sampler ``name`` (a key of ``SAMPLERS``) from
    the reference state's fields as numpy (``state._asdict()``): f32
    tensors, and the alias table's indices as int32."""
    dev = resolve(device)
    cls = SAMPLER_STATES[name]
    return cls(**{k: torch.as_tensor(np.array(fields[k],
                                              np.int32 if k == "alias"
                                              else np.float32), device=dev)
                  for k in cls._fields})


def sampler_state_to_reference(state: tuple) -> dict:
    """A port sampler state's fields as numpy, for
    ``<State>(**{k: jnp.asarray(v)})`` in the reference."""
    return {k: v.cpu().numpy() for k, v in state._asdict().items()}
