"""Carry the JAX reference's state into the port and back, as numpy arrays.

The port never imports ``jax``; a caller holding the reference's arrays
passes them here as numpy (``np.asarray(x)``, and for a key
``np.asarray(jax.random.key_data(k))``).  What crosses:

* a φ snapshot (:func:`snapshot_from_reference`) and keys
  (:func:`key_from_reference`);
* the serial chain state, ``LDAState`` with its key as ``key_data``
  (:func:`state_from_reference`, :func:`state_to_reference`);
* the ``NomadLDA.init_arrays``/``sweep`` dict (:func:`nomad_arrays_from_
  reference`, :func:`nomad_arrays_to_reference`).  The reference keeps
  ``tok_valid``/``tok_bound`` as bool; the port as 0/1 int32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch._device import resolve
from repro_torch.core.cgs import LDAState
from repro_torch.serve.lda_engine import PhiSnapshot

__all__ = ["snapshot_from_reference", "key_from_reference",
           "state_from_reference", "state_to_reference",
           "nomad_arrays_from_reference", "nomad_arrays_to_reference"]

_BOOL_FIELDS = ("tok_valid", "tok_bound")


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
    dev = resolve(device)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    return LDAState(z=i32(z), n_td=i32(n_td), n_wt=i32(n_wt), n_t=i32(n_t),
                    key=rng.wrap_key_data(key_data, dev))


def state_to_reference(state: LDAState) -> dict:
    """``{z, n_td, n_wt, n_t, key_data}`` as numpy, for
    ``LDAState(..., key=jax.random.wrap_key_data(key_data))``."""
    out = {k: getattr(state, k).cpu().numpy().astype(np.int32)
           for k in ("z", "n_td", "n_wt", "n_t")}
    out["key_data"] = rng.key_data(state.key)
    return out


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
