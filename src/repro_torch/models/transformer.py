"""The decoder/encoder transformer of the ten zoo archs
(``repro/models/transformer.py``), as ``nn.Module``s run by a Python loop.

The layer stack is planned as the reference plans it, in homogeneous
**segments** (same mixer and MLP kind): :func:`segments` is the
reference's.  The reference stacks each segment's layers and scans them;
here :class:`Transformer` holds a ``ModuleList`` of layer modules per
segment and runs them in order.  Every parameter's name is the
reference's dict path with the layer's index after the segment's
(``segments.{s}.{i}.mixer.wq`` is ``params["segments"][s]["mixer"]["wq"]
[i]``), so carrying weights across is a name map plus slicing the stacked
arrays (:mod:`repro_torch.convert`).  Heterogeneity is the reference's:

* per-layer windows inside a segment (gemma2's local/global alternation);
* a short unstacked dense prefix (deepseek-moe's ``first_k_dense``);
* zamba2's *shared* attention block after every ``attn_every``-th layer,
  one parameter set with a cache of its own, indexed by how many times
  the block has been applied.

Audio and vision frontends are stubs, as in the reference: the model
takes precomputed frame or patch embeddings through a linear projection.

Caches mirror the reference's pytree: ``{"segments": [per-segment dicts
of tensors stacked over the segment's layers], "shared_attn": ...}``.
A forward with a cache writes the step's state into those tensors in
place and returns the cache.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharded
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, dense_init, embed_init,
                                       mlp_forward, param, rmsnorm, softcap)

__all__ = ["init_params", "empty_params", "forward", "head_weight",
           "init_cache", "segments", "Segment", "Transformer"]

#: Cache entries a step replaces; ``k``/``v`` it writes row by row.
_STATE_KEYS = ("len", "slot_pos", "conv", "ssm")


@dataclass(frozen=True)
class Segment:
    mixer: str            # 'attn' | 'ssm'
    mlp: str              # 'dense' | 'moe' | 'none'
    count: int
    local_flags: tuple    # per-layer sliding-window on/off (attn segments)
    shared_attn_every: int = 0   # hybrid: shared block cadence


def segments(cfg: ModelConfig) -> list[Segment]:
    if cfg.arch_type == "hybrid":
        return [Segment(mixer="ssm", mlp="dense", count=cfg.num_layers,
                        local_flags=(), shared_attn_every=cfg.attn_every)]
    kinds, mlps = cfg.layer_kinds(), cfg.mlp_kinds()
    segs: list[Segment] = []
    i = 0
    while i < cfg.num_layers:
        mixer = "ssm" if kinds[i] == "ssm" else "attn"
        mlp = mlps[i]
        j = i
        flags = []
        while j < cfg.num_layers and mlps[j] == mlp \
                and (("ssm" if kinds[j] == "ssm" else "attn") == mixer):
            flags.append(kinds[j] == "attn_local")
            j += 1
        segs.append(Segment(mixer=mixer, mlp=mlp, count=j - i,
                            local_flags=tuple(flags)))
        i = j
    return segs


def _zeros(d: int, dtype, device) -> nn.Parameter:
    return param(torch.zeros(d, dtype=dtype, device=device))


class Layer(nn.Module):
    """``norm1``, ``norm2``, ``mixer`` (attention or SSM) and ``mlp``
    (dense, MoE or none, as the segment says: a hybrid segment says
    ``dense``, so zamba2's layers carry an MLP each, as the reference's
    do, though ``ModelConfig.mlp_kinds`` counts none for them)."""

    def __init__(self, gen, cfg, seg: Segment, dtype, device):
        super().__init__()
        self.norm1 = _zeros(cfg.d_model, dtype, device)
        self.norm2 = _zeros(cfg.d_model, dtype, device)
        if seg.mixer == "attn":
            self.mixer = attn_mod.Attention(gen, cfg, dtype, device)
        else:
            self.mixer = ssm_mod.SSM(gen, cfg, dtype, device)
        if seg.mlp == "dense":
            self.mlp = MLP(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype,
                           device)
        elif seg.mlp == "moe":
            self.mlp = moe_mod.MoE(gen, cfg, dtype, device)


class SharedAttention(nn.Module):
    """zamba2's shared block: ``norm``, ``attn``, ``norm2``, ``mlp``."""

    def __init__(self, gen, cfg, dtype, device):
        super().__init__()
        self.norm = _zeros(cfg.d_model, dtype, device)
        self.attn = attn_mod.Attention(gen, cfg, dtype, device)
        self.norm2 = _zeros(cfg.d_model, dtype, device)
        self.mlp = MLP(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype,
                       device)


class Transformer(nn.Module):
    """The whole model's weights, run by :func:`forward`."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype,
                 device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.embed = embed_init(gen, cfg.vocab_size, d, dtype, device)
        self.final_norm = _zeros(d, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = dense_init(gen, d, cfg.vocab_size, dtype, device)
        if cfg.modality != "text":
            fd = cfg.frontend_dim or d
            self.frontend_proj = dense_init(gen, fd, d, dtype, device)
        self.segments = nn.ModuleList(
            nn.ModuleList(Layer(gen, cfg, seg, dtype, device)
                          for _ in range(seg.count))
            for seg in segments(cfg))
        if cfg.arch_type == "hybrid" and cfg.attn_every:
            self.shared_attn = SharedAttention(gen, cfg, dtype, device)


def init_params(cfg: ModelConfig, gen, dtype=torch.float32,
                device=None) -> Transformer:
    """Random weights from ``gen`` (a ``torch.Generator`` on ``device``,
    or an int seed for one) on ``device`` (CUDA unless ``"cpu"``)."""
    dev = resolve(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    return Transformer(cfg, gen, dtype, dev)


def empty_params(cfg: ModelConfig, dtype=torch.float32,
                 device=None) -> Transformer:
    """A model whose weights are allocated on ``device`` but not drawn,
    to be filled by ``load_state_dict``."""
    meta = Transformer(cfg, torch.Generator(), dtype, torch.device("meta"))
    return meta.to_empty(device=resolve(device))


# ---------------------------------------------------------------------------
# Cache.
# ---------------------------------------------------------------------------
def _stack(one: dict, n: int) -> dict:
    return {k: v.unsqueeze(0).expand(n, *v.shape).clone()
            for k, v in one.items()}


def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype=torch.float32,
               ring: bool = False, device=None) -> dict:
    """ring=True: attention segments whose layers are all local keep a
    window-sized ring instead of an S_max cache."""
    dev = resolve(device)
    out = {"segments": []}
    for seg in segments(cfg):
        if seg.mixer == "attn":
            all_local = bool(seg.local_flags) and all(seg.local_flags)
            one = attn_mod.init_attn_cache(cfg, B, S_max, dtype,
                                           ring=ring and all_local,
                                           device=dev)
        else:
            one = ssm_mod.init_ssm_cache(cfg, B, dtype, device=dev)
        out["segments"].append(_stack(one, seg.count))
    if cfg.arch_type == "hybrid" and cfg.attn_every:
        n_apps = cfg.num_layers // cfg.attn_every
        out["shared_attn"] = _stack(
            attn_mod.init_attn_cache(cfg, B, S_max, dtype, device=dev),
            n_apps)
    return out


def _layer_cache(stacked: dict | None, i: int) -> dict | None:
    return None if stacked is None else {k: v[i] for k, v in stacked.items()}


def _store(stacked: dict, i: int, new: dict) -> None:
    for k in _STATE_KEYS:
        if k in new:
            stacked[k][i].copy_(new[k])


# ---------------------------------------------------------------------------
# Forward.
# ---------------------------------------------------------------------------
def _embed_inputs(params, cfg, batch):
    """The input rows: frames or patches through the frontend stub's
    projection (patches before the tokens' embeddings), else tokens."""
    if cfg.modality == "audio_frames":
        return batch["frames"] @ params.frontend_proj
    # embed[tokens], vocabulary-parallel on a DTensor table
    x = sharded.vocab_pick(lambda t, i: t[i], params.embed, batch["tokens"],
                           0, batched=False)
    if cfg.modality == "image_patches" and "patches" in batch:
        x = torch.cat([batch["patches"] @ params.frontend_proj, x], dim=1)
    return x


def _mixer_apply(seg, cfg, lp, x, positions, cache_l, window,
                 attn_seq_sharding=None):
    h = rmsnorm(x, lp.norm1, cfg.norm_eps)
    if seg.mixer == "attn":
        if h.shape[1] > 1:
            # context parallelism: the sequence over the model axis for
            # attention (heads that do not divide it)
            h = sharded.constrain(h, attn_seq_sharding)
        y, new_cache = attn_mod.attn_forward(
            lp.mixer, cfg, h, local=window, positions=positions,
            cache=cache_l, norm_eps=cfg.norm_eps)
    else:
        y, new_cache = ssm_mod.ssm_forward(lp.mixer, cfg, h, cache_l)
    return x + y, new_cache


def _mlp_apply(seg, cfg, lp, x, ep_ctx):
    if seg.mlp == "none":
        return x, 0.0
    h = rmsnorm(x, lp.norm2, cfg.norm_eps)
    if seg.mlp == "dense":
        return x + mlp_forward(lp.mlp, h, cfg.activation), 0.0
    y, aux = ep_ctx(lp.mlp, h) if ep_ctx is not None else lp.mlp(h)
    return x + y, aux


def _shared_apply(cfg, shared, x, positions, shared_cache, app_idx):
    h = rmsnorm(x, shared.norm, cfg.norm_eps)
    cache_one = _layer_cache(shared_cache, app_idx)
    y, cache_new = attn_mod.attn_forward(
        shared.attn, cfg, h, local=0, positions=positions, cache=cache_one,
        norm_eps=cfg.norm_eps)
    if shared_cache is not None:
        _store(shared_cache, app_idx, cache_new)
    x = x + y
    h2 = rmsnorm(x, shared.norm2, cfg.norm_eps)
    return x + mlp_forward(shared.mlp, h2, cfg.activation)


def _run_segment(seg: Segment, cfg, layers, x, positions, cache_seg,
                 shared, shared_cache, ep_ctx, layer_remat: bool = False,
                 act_sharding=None, attn_seq_sharding=None):
    windows = [cfg.sliding_window if f else 0 for f in seg.local_flags] \
        or [0] * seg.count

    def body(i, x):
        lp = layers[i]
        # pin the layer carry (and what remat saves of it) to the batch
        # sharding, as the reference does
        x = sharded.constrain(x, act_sharding)
        x, new_cache = _mixer_apply(seg, cfg, lp, x, positions,
                                    _layer_cache(cache_seg, i), windows[i],
                                    attn_seq_sharding)
        if cache_seg is not None:
            _store(cache_seg, i, new_cache)
        x, aux = _mlp_apply(seg, cfg, lp, x, ep_ctx)
        x = sharded.constrain(x, act_sharding)
        if seg.shared_attn_every and (i + 1) % seg.shared_attn_every == 0:
            # the shared block's applications so far in this segment
            x = _shared_apply(cfg, shared, x, positions, shared_cache,
                              (i + 1) // seg.shared_attn_every - 1)
        return x, aux

    if layer_remat and cache_seg is None and torch.is_grad_enabled():
        # per-layer remat: a layer keeps only its input for the backward
        # and recomputes everything inside it, as the reference's
        # ``nothing_saveable`` policy does
        def step(i, x):
            return checkpoint(body, i, x, use_reentrant=False)
    else:
        step = body
    aux = 0.0
    for i in range(seg.count):
        x, aux_i = step(i, x)
        aux = aux + aux_i
    return x, aux


def forward(params, cfg: ModelConfig, batch, *, cache=None, ep_ctx=None,
            return_hidden: bool = False, act_sharding=None,
            layer_remat: bool = False, attn_seq_sharding=None):
    """Returns (logits, cache, aux_loss).

    batch: {"tokens": (B,S)} (+ "pos" (B,) with a cache) | {"frames"} |
    {"tokens", "patches"}.  cache: from :func:`init_cache`, updated in
    place, or None.  ep_ctx: an optional callable (moe_module, x) -> (y,
    aux) in place of the MoE layers' own (``launch/ep.py``).
    return_hidden: the final-norm hidden states instead of logits.
    layer_remat: without a cache and with gradients on, each layer is
    checkpointed and recomputed in the backward.  act_sharding and
    attn_seq_sharding are the reference's sharding constraints, taken
    only by a model whose weights are DTensors: None, or a
    ``launch/sharding_rules.NamedSharding`` that each layer's carry, or
    the attention input, is redistributed to.
    """
    if (act_sharding is not None or attn_seq_sharding is not None) and \
            not sharded.is_sharded(next(params.parameters())):
        raise ValueError("act_sharding and attn_seq_sharding constrain a "
                         "mesh; a model on one device (plain tensors) "
                         "takes only None")
    x = _embed_inputs(params, cfg, batch)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None, :]
    if cache is not None and "pos" in batch:
        positions = batch["pos"][:, None] + positions
    else:
        positions = positions.expand(B, S)

    shared = getattr(params, "shared_attn", None)
    shared_cache = cache.get("shared_attn") if cache is not None else None
    aux_total = 0.0
    for si, seg in enumerate(segments(cfg)):
        cache_seg = cache["segments"][si] if cache is not None else None
        x, aux = _run_segment(seg, cfg, params.segments[si], x, positions,
                              cache_seg, shared, shared_cache, ep_ctx,
                              layer_remat, act_sharding, attn_seq_sharding)
        aux_total = aux_total + aux

    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    if return_hidden:
        return x, cache, aux_total
    return softcap(x @ head_weight(params), cfg.final_logit_softcap), \
        cache, aux_total


def head_weight(params) -> torch.Tensor:
    """The (d, V) matrix that takes final-norm hidden states to logits:
    ``lm_head``, or the embedding transposed where it is tied."""
    head = getattr(params, "lm_head", None)
    return head if head is not None else params.embed.T
