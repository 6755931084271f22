"""Carry the JAX reference's state into the port, as numpy arrays.

The port never imports ``jax``; a caller holding the reference's φ table
and keys passes them here as numpy (``np.asarray(phi)``,
``np.asarray(jax.random.key_data(k))``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch.serve.lda_engine import PhiSnapshot

__all__ = ["snapshot_from_reference", "key_from_reference"]


def snapshot_from_reference(phi: np.ndarray, meta: dict) -> PhiSnapshot:
    """A port snapshot from a reference ``PhiSnapshot``'s table and meta.
    The digest travels in ``meta``; ``LdaEngine.publish`` verifies it."""
    return PhiSnapshot(phi=np.asarray(phi, np.float32), meta=dict(meta))


def key_from_reference(key_data: np.ndarray, device=None) -> torch.Tensor:
    """A port key (or batch of keys) from ``jax.random.key_data(k)``."""
    return rng.wrap_key_data(key_data, device)
