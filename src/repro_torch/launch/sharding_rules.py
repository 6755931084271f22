"""Parameter / activation / cache sharding rules for the production mesh
(``repro/launch/sharding_rules.py``), as DTensor placements.

Layout (DESIGN.md §4):
    batch                over ('pod','data')   (or ('data',) single-pod)
    TP (heads, d_ff, vocab, experts) over 'model'
    FSDP: contracting dims of big weight matrices additionally over 'data'
          (required for kimi-k2: 1T params / 512 chips).

A spec is a :class:`PartitionSpec`: a tuple with one entry a dimension,
``None``, an axis name or a tuple of axis names (sharded over their
product, the first axis major), entry for entry the reference's ``P``.
:func:`to_placements` turns a spec into DTensor placements.

The rules are the reference's, keyed on the reference's parameter paths
and ranks.  The reference stacks each segment's layers on a leading axis
that is never sharded; the port keeps one module a layer
(``segments.{s}.{i}...``), so a per-layer weight is classified by its
reference path (``segments/{s}/...``) and its rank plus one, and its
spec drops that leading entry.  Without this an expert weight (E, d, f)
would read as a dense (L, d, f) MLP.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["PartitionSpec", "NamedSharding", "batch_axes", "param_specs",
           "cache_specs", "batch_specs", "train_state_specs",
           "sanitize_spec", "to_placements", "with_sharding",
           "reference_path"]


class PartitionSpec(tuple):
    """``PartitionSpec("model", None)``: one entry a dimension.  A tuple
    of one axis is that axis, as the reference's ``P`` normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec on a mesh: what ``transformer.forward``'s ``act_sharding``
    and ``attn_seq_sharding`` take, and what :func:`with_sharding`
    places a tensor by."""
    mesh: DeviceMesh
    spec: PartitionSpec

    def constrain(self, x: DTensor) -> DTensor:
        """x redistributed to this sharding (the spec sanitized against
        x's shape first)."""
        spec = sanitize_spec(self.spec, tuple(x.shape), self.mesh)
        return x.redistribute(self.mesh, to_placements(spec, self.mesh))


def _mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def reference_path(name: str) -> tuple[str, bool]:
    """The reference's pytree path of a port parameter name, and whether
    the reference stacks it over a segment's layers:
    ``segments.0.3.mixer.wq`` is ``segments/0/mixer/wq``, stacked."""
    parts = name.split(".")
    if parts[0] == "segments":
        return "/".join(parts[:2] + parts[3:]), True
    return "/".join(parts), False


def _param_spec(path: str, ndim: int, fsdp: bool,
                attn_model_shard: bool = True) -> P:
    """The reference's spec for one parameter of reference ``path`` and
    rank ``ndim`` (stacked leaves counted with their layer axis)."""
    d_axis = "data" if fsdp else None

    def pad(spec_tail: tuple) -> P:
        return P(*([None] * (ndim - len(spec_tail)) + list(spec_tail)))

    name = path.split("/")[-1]
    if name in ("embed",):
        return P("model", d_axis)
    if name == "lm_head":
        return pad((d_axis, "model"))
    if name == "frontend_proj":
        return pad((None, None))
    # attention
    if name in ("wq", "wk", "wv"):
        return pad((d_axis, "model" if attn_model_shard else None))
    if name == "wo":
        return pad(("model" if attn_model_shard else None, d_axis))
    # mlp (dense + shared experts)
    if name in ("w_gate", "w_up") and "mlp" in path and ndim <= 3 \
            and "shared" not in path:
        return pad((d_axis, "model"))
    if "shared" in path and name in ("w_gate", "w_up"):
        return pad((d_axis, "model"))
    if "shared" in path and name == "w_down":
        return pad(("model", d_axis))
    if name == "w_down" and ndim <= 3:
        return pad(("model", d_axis))
    # MoE routed experts: (L, E, d, f) / (L, E, f, d) → experts over model,
    # contracting dim over 'data' when FSDP is on.
    if name in ("w_gate", "w_up", "w_down") and ndim >= 4:
        return P(*([None] * (ndim - 3)), "model", d_axis, None)
    if name == "router":
        return pad((None, "model"))
    # ssm
    if name == "in_proj":
        return pad((d_axis, "model"))
    if name == "out_proj":
        return pad(("model", d_axis))
    if name in ("conv_w", "conv_b"):
        return pad(("model",)) if name == "conv_b" else pad((None, "model"))
    # norms, scalars, A_log, dt_bias, D, q_norm, k_norm …
    return P(*([None] * ndim))


def param_spec(name: str, ndim: int, *, fsdp: bool = False,
               attn_model_shard: bool = True) -> P:
    """The spec of the port parameter ``name`` of rank ``ndim``."""
    path, stacked = reference_path(name)
    spec = _param_spec(path, ndim + stacked, fsdp, attn_model_shard)
    return P(*spec[1:]) if stacked else spec


def param_specs(params, mesh=None, *, fsdp: bool = False,
                attn_model_shard: bool = True) -> dict:
    """{parameter name: spec} for a model (an ``nn.Module``) or a dict
    of name -> tensor."""
    named = params.named_parameters() if isinstance(
        params, torch.nn.Module) else params.items()
    return {k: param_spec(k, v.ndim, fsdp=fsdp,
                          attn_model_shard=attn_model_shard)
            for k, v in named}


def _cache_spec(name: str, shape: tuple, baxes, bsize: int) -> P:
    ndim = len(shape)
    lead = ndim - {"k": 4, "v": 4, "len": 1, "conv": 3, "ssm": 4,
                   "slot_pos": 2}[name]
    pre = [None] * lead
    B = shape[lead]
    batch_shardable = B % bsize == 0
    if name in ("k", "v"):       # (…,B,S,Hkv,Dh)
        if batch_shardable:
            return P(*pre, baxes, None, "model", None)
        # tiny-batch long-context decode: shard the sequence axis instead
        return P(*pre, None, baxes, "model", None)
    if name == "len":            # (…,B)
        return P(*pre, baxes) if batch_shardable else P(*pre, None)
    if name == "slot_pos":       # (…,B,S_cache) ring-buffer positions
        return P(*pre, baxes if batch_shardable else None, None)
    if name == "conv":           # (…,B,W-1,C)
        return P(*pre, baxes if batch_shardable else None, None, "model")
    if name == "ssm":            # (…,B,H,P,N)
        if batch_shardable:
            return P(*pre, baxes, "model", None, None)
        return P(*pre, None, "model", baxes, None)
    raise ValueError(name)


def _map_leaves(tree, fn):
    """``fn(leaf name, leaf)`` over a cache's nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: (_map_leaves(v, fn) if isinstance(v, (dict, list))
                    else fn(k, v)) for k, v in tree.items()}
    return [_map_leaves(v, fn) for v in tree]


def cache_specs(cache, mesh) -> dict:
    """The cache's specs, in its own structure (the port's caches are
    the reference's pytree, stacked the same way)."""
    baxes = batch_axes(mesh)
    sizes = _mesh_shape(mesh)
    bsize = 1
    for a in baxes:
        bsize *= sizes[a]
    return _map_leaves(cache, lambda k, leaf: _cache_spec(
        k, tuple(leaf.shape), baxes, bsize))


def batch_specs(batch: dict, mesh) -> dict:
    baxes = batch_axes(mesh)
    return {k: P(baxes, *([None] * (v.ndim - 1))) for k, v in batch.items()}


def train_state_specs(state, mesh=None, *, fsdp: bool = False,
                      attn_model_shard: bool = True) -> dict:
    """A train state's specs, ``{"params", "step", "m", "v"}``: AdamW's
    m and v mirror the params, the step is replicated."""
    p_specs = param_specs(state.params, mesh, fsdp=fsdp,
                          attn_model_shard=attn_model_shard)
    return {"params": p_specs, "step": P(), "m": dict(p_specs),
            "v": dict(p_specs)}


def sanitize_spec(spec: P, shape: tuple, mesh) -> P:
    """Drop spec axes that do not divide the dimension (e.g. odd vocabs)."""
    sizes = _mesh_shape(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= sizes[a]
        out.append(entry if dim % size == 0 else None)
    return P(*out)


def to_placements(spec: P, mesh: DeviceMesh) -> tuple:
    """DTensor placements, one a mesh dimension, for ``spec``.  A tensor
    dimension over several axes is sharded over them in mesh order, the
    first major, which is the order of the reference's ``P(("pod",
    "data"))``; an entry that names its axes in another order is
    refused."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} are not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: axis {names[i]} shards two "
                                 "dimensions")
            # one shard over an axis of one device is the whole tensor
            if mesh.shape[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def local_shape(shape: tuple, spec: P, mesh) -> tuple:
    """The shape of one device's shard of a tensor of ``shape`` placed
    by the sanitized ``spec``."""
    sizes = _mesh_shape(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[dim] //= sizes[a]
    return tuple(out)


def with_sharding(t: torch.Tensor, spec: P, mesh,
                  requires_grad: bool = False) -> DTensor:
    """A DTensor of ``t``'s shape and dtype placed by ``spec`` (sanitized
    first: an axis that does not divide its dimension is dropped, so no
    shard is uneven), its local shard an empty tensor on ``t``'s device
    (``meta``, or fake under ``FakeTensorMode``): the counterpart of the
    reference's ``sds_with_sharding``."""
    spec = sanitize_spec(spec, tuple(t.shape), mesh)
    local = torch.empty(local_shape(tuple(t.shape), spec, mesh),
                        dtype=t.dtype, device=t.device)
    stride, n = [], 1
    for s in reversed(t.shape):
        stride.insert(0, n)
        n *= s
    out = DTensor.from_local(local, mesh, to_placements(spec, mesh),
                             run_check=False, shape=t.shape,
                             stride=tuple(stride))
    return out.requires_grad_(requires_grad) if requires_grad else out
