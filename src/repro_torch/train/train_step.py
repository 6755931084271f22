"""Training step (``repro/train/train_step.py``): loss, grads, AdamW
update, remat.

A :class:`TrainState` holds the model (a ``Transformer`` whose weights
take gradients) and its :class:`~repro_torch.train.optimizer.AdamWState`,
whose m and v are keyed by the model's parameter names.  A step updates
the weights and moments in place and returns the state.

Remat as the reference's ``jax.checkpoint`` policies, through
``torch.utils.checkpoint`` (non-reentrant):

* ``remat=True``: the whole loss is checkpointed, keeping the outputs of
  the matrix products without batch dimensions (``aten.mm``: every
  ``x @ w`` of a projection; the zoo has no biases, so no ``addmm``) and
  recomputing the rest, as
  ``dots_with_no_batch_dims_saveable`` does;
* ``layer_remat=True``: each layer keeps only its input
  (``nothing_saveable``), and overrides ``remat``;
* the chunked CE checkpoints each chunk, so only one chunk's logits are
  alive at a time, in the forward and in the backward.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import sharded, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import softcap
from repro_torch.train.optimizer import AdamWState, adamw_init, adamw_update

__all__ = ["TrainState", "init_train_state", "train_state", "loss_fn",
           "value_and_grad", "make_train_step"]


class TrainState(NamedTuple):
    params: transformer.Transformer
    opt: AdamWState


def train_state(params: transformer.Transformer,
                opt: AdamWState | None = None) -> TrainState:
    """A state around ``params``, gradients turned on for every weight;
    fresh AdamW moments unless ``opt`` is given."""
    params.requires_grad_(True)
    return TrainState(params=params, opt=opt or adamw_init(
        dict(params.named_parameters())))


def init_train_state(cfg: ModelConfig, gen, dtype=torch.float32,
                     device=None) -> TrainState:
    """Params in ``dtype`` drawn from ``gen`` (a generator or a seed, as
    ``transformer.init_params`` takes it) on ``device`` (CUDA unless
    ``"cpu"``); AdamW's m and v stay f32."""
    return train_state(transformer.init_params(cfg, gen, dtype, device))


def _cross_entropy(logits, targets, mask):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    nll = _gold_nll(logits, logz, targets) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def _gold_nll(logits, logz, targets):
    """logz minus each row's gold logit (vocabulary-parallel on DTensor
    logits)."""
    gold = sharded.vocab_pick(lambda t, i: torch.gather(t, -1, i[..., None]),
                              logits, targets, -1, batched=True)
    return (logz[..., None] - gold)[..., 0]


def _chunk_nll(xs, head, ts, ms, cap):
    logits = softcap(xs @ head, cap).float()
    logz = torch.logsumexp(logits, dim=-1)
    return (_gold_nll(logits, logz, ts) * ms).sum()


def _chunked_ce_from_hidden(x, head, targets, mask, cap, chunk=512):
    """CE taken a sequence chunk at a time, so the (B, S, V) logits never
    exist whole: S splits into chunks of ``chunk`` where it is a multiple
    of it, else runs as one chunk, as in the reference.  Each chunk is
    checkpointed; the chunks' sums are added in order."""
    S = x.shape[1]
    n = S // chunk if S % chunk == 0 else 1
    chunk = S // n
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        part = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(_chunk_nll, x[:, part], head,
                                   targets[:, part], mask[:, part], cap,
                                   use_reentrant=False)
    return total / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, cfg: ModelConfig, batch, *, ep_ctx=None,
            chunked_ce: bool = False, act_sharding=None,
            layer_remat: bool = False):
    """Next-token CE (text, vlm) or frame classification CE (audio), plus
    ``router_aux_coef`` times the MoE load-balance term.  Returns
    (loss, {"ce", "aux"})."""
    kw = dict(ep_ctx=ep_ctx, act_sharding=act_sharding,
              layer_remat=layer_remat)
    if chunked_ce and cfg.modality == "text":
        hidden, _, aux = transformer.forward(params, cfg, batch,
                                             return_hidden=True, **kw)
        targets = batch["tokens"][:, 1:]
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=hidden.device)
        ce = _chunked_ce_from_hidden(hidden[:, :-1],
                                     transformer.head_weight(params),
                                     targets, mask, cfg.final_logit_softcap)
    else:
        logits, _, aux = transformer.forward(params, cfg, batch, **kw)
        if cfg.modality == "audio_frames":
            targets = batch["labels"]
        elif cfg.modality == "image_patches":
            # loss on text positions only (the patches are the prefix)
            n_p = batch["patches"].shape[1]
            targets, logits = batch["tokens"][:, 1:], logits[:, n_p:-1]
        else:
            targets, logits = batch["tokens"][:, 1:], logits[:, :-1]
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=logits.device)
        ce = _cross_entropy(logits, targets, mask)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}


def _dots_saveable(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: a 2-D matrix product's
    output is kept, every other op is recomputed (a batched product is
    ``bmm``; ``x @ w`` with x of any rank reaches ``mm``)."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def value_and_grad(params, cfg: ModelConfig, batch, *, remat: bool = True,
                   ep_ctx=None, chunked_ce: bool = False,
                   act_sharding=None, layer_remat: bool = False):
    """((loss, {"ce", "aux"}), grads): the loss as ``make_train_step``
    takes it, under the same remat, and its gradient by every weight of
    ``params`` (name -> tensor; zeros for a weight the loss does not
    reach).  The loss and metrics come back detached."""
    if layer_remat:
        remat = False            # per-layer remat supersedes whole-loss remat
    loss = functools.partial(loss_fn, cfg=cfg, ep_ctx=ep_ctx,
                             chunked_ce=chunked_ce,
                             act_sharding=act_sharding,
                             layer_remat=layer_remat)
    named = dict(params.named_parameters())
    if remat:
        value, metrics = checkpoint(
            loss, params, batch=batch, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _dots_saveable))
    else:
        value, metrics = loss(params, batch=batch)
    grads = torch.autograd.grad(value, list(named.values()),
                                allow_unused=True, materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (value.detach(), metrics), dict(zip(named, grads))


def make_train_step(cfg: ModelConfig, *, lr=3e-4, remat: bool = True,
                    ep_ctx=None, chunked_ce: bool = False,
                    act_sharding=None, layer_remat: bool = False):
    """Build train_step(state, batch) -> (state, metrics), metrics
    ``ce``, ``aux``, ``loss`` and ``grad_norm`` as detached () tensors."""
    kw = dict(remat=remat, ep_ctx=ep_ctx, chunked_ce=chunked_ce,
              act_sharding=act_sharding, layer_remat=layer_remat)

    def step(state: TrainState, batch):
        (value, metrics), grads = value_and_grad(state.params, cfg, batch,
                                                 **kw)
        _, opt, gnorm = adamw_update(dict(state.params.named_parameters()),
                                     grads, state.opt, lr=lr)
        del grads
        metrics.update(loss=value, grad_norm=gnorm)
        return TrainState(params=state.params, opt=opt), metrics

    return step
