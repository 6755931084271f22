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
  (:func:`sampler_state_from_reference`, :func:`sampler_state_to_reference`);
* the model zoo's weights (:func:`params_from_reference`,
  :func:`params_to_reference`) and decode caches
  (:func:`cache_from_reference`, :func:`cache_to_reference`), as nested
  dicts and lists of numpy arrays (``jax.tree_util.tree_map(np.asarray,
  params)``).  The reference stacks a segment's layers in one array per
  weight; the port keeps a module per layer, named by the reference's
  path with the layer's index after the segment's;
* a training state, the params and AdamW's step, m and v
  (:func:`train_state_from_reference`, :func:`train_state_to_reference`):
  m and v take the params' name map.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch._device import resolve
from repro_torch.core import samplers
from repro_torch.core.cgs import (LDAState, state_from_checkpoint,
                                 state_to_checkpoint)
from repro_torch.models.transformer import Transformer, empty_params
from repro_torch.serve.lda_engine import PhiSnapshot

__all__ = ["snapshot_from_reference", "key_from_reference",
           "state_from_reference", "state_to_reference",
           "nomad_arrays_from_reference", "nomad_arrays_to_reference",
           "sampler_state_from_reference", "sampler_state_to_reference",
           "SAMPLER_STATES", "params_from_reference", "params_to_reference",
           "cache_from_reference", "cache_to_reference", "load_module",
           "train_state_from_reference", "train_state_to_reference",
           "named_from_reference", "named_to_reference"]

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


def _leaves(tree, prefix: str = ""):
    """(dotted path, array) for every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def load_module(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Copy a reference weight dict (numpy leaves, nothing stacked) into
    the port module that mirrors it, in place: ``attn_init``'s into an
    ``Attention``, ``moe_init``'s into a ``MoE`` and so on."""
    dev = next(module.parameters()).device
    module.load_state_dict({k: torch.as_tensor(np.array(v), device=dev)
                            for k, v in _leaves(tree)}, strict=True)
    return module


def named_from_reference(tree: dict) -> dict:
    """{port parameter name: numpy array} from a reference weight tree:
    the segments' stacked arrays sliced into one entry a layer."""
    out = {name: np.asarray(arr) for name, arr in _leaves(
        {k: v for k, v in tree.items() if k != "segments"})}
    for si, seg in enumerate(tree["segments"]):
        for name, arr in _leaves(seg):
            arr = np.asarray(arr)
            for li in range(arr.shape[0]):
                out[f"segments.{si}.{li}.{name}"] = arr[li]
    return out


def named_to_reference(named) -> dict:
    """The inverse of :func:`named_from_reference`, from (name, tensor)
    pairs; bf16 comes out as f32 (numpy has no bf16), losslessly."""
    out: dict = {}
    stacked: dict = {}
    for name, t in named:
        t = t.detach().cpu()
        t = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        parts = name.split(".")
        if parts[0] == "segments":
            si, li = int(parts[1]), int(parts[2])
            stacked.setdefault(si, {}).setdefault(tuple(parts[3:]), {})[li] = t
            continue
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    out["segments"] = []
    for si in sorted(stacked):
        seg: dict = {}
        for path, layers in stacked[si].items():
            node = seg
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = np.stack([layers[i]
                                       for i in range(len(layers))])
        out["segments"].append(seg)
    return out


def params_from_reference(tree: dict, cfg, device=None,
                          dtype=None) -> Transformer:
    """A :class:`Transformer` holding the reference's weights ``tree``
    (its ``init_params`` dict, numpy leaves; ``segments`` a list of
    dicts whose arrays stack the segment's layers on axis 0).  ``dtype``
    defaults to the arrays' own."""
    state = {k: torch.as_tensor(np.array(v))
             for k, v in named_from_reference(tree).items()}
    model = empty_params(cfg, dtype or state["embed"].dtype, device)
    model.load_state_dict(state, strict=True)
    return model


def params_to_reference(model: Transformer) -> dict:
    """The reference's weight dict (numpy leaves) from a port model: the
    inverse of :func:`params_from_reference`."""
    return named_to_reference(model.state_dict().items())


def train_state_from_reference(state, cfg, device=None, dtype=None):
    """The port's ``TrainState`` from the reference's, as numpy leaves
    (``jax.tree_util.tree_map(np.asarray, state)``): the params as by
    :func:`params_from_reference`, AdamW's m and v (f32) under the
    params' port names, and the step as a () int32 tensor."""
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import train_state
    params = params_from_reference(state.params, cfg, device, dtype)
    opt, dev = state.opt, params.embed.device

    def moments(tree):
        return {k: torch.as_tensor(np.array(v, np.float32), device=dev)
                for k, v in named_from_reference(tree).items()}
    return train_state(params, AdamWState(
        step=torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                          device=dev),
        m=moments(opt.m), v=moments(opt.v)))


def train_state_to_reference(state) -> dict:
    """``{"params", "step", "m", "v"}`` as the reference's trees (numpy
    leaves) from a port ``TrainState``, for ``TrainState(params=...,
    opt=AdamWState(step=jnp.asarray(step), m=m, v=v))``."""
    opt = state.opt
    return {"params": params_to_reference(state.params),
            "step": np.asarray(int(opt.step), np.int32),
            "m": named_to_reference(opt.m.items()),
            "v": named_to_reference(opt.v.items())}


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def cache_from_reference(tree: dict, device=None) -> dict:
    """A port decode cache from the reference's (``init_cache`` /
    ``prefill`` pytree, numpy leaves): the same structure, each leaf a
    tensor on ``device``."""
    dev = resolve(device)
    return _map_tree(tree, lambda a: torch.as_tensor(np.array(a),
                                                     device=dev))


def cache_to_reference(cache: dict) -> dict:
    """The reference's cache pytree, numpy leaves, from a port cache."""
    return _map_tree(cache, lambda t: t.cpu().numpy())
