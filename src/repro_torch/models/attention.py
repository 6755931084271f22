"""Grouped-query attention with RoPE, qk-norm, soft-capping and a sliding
window (``repro/models/attention.py``), in plain PyTorch ops.

The scores are taken in f32 by ``einsum`` and normalised by ``softmax``
in f32, as the reference does; masked scores are set to -1e30, not -inf,
so a row with no visible key comes out uniform there as here.  Queries
longer than ``Q_CHUNK`` are taken a chunk at a time, so the (Sq, Sk)
score matrix never exists beyond one chunk.  ``scaled_dot_product_
attention`` is not used: its flash path takes neither the -1e30 /
softcap / key-position masks nor the reference's order of operations.

Caches are dicts of tensors, ``{"k", "v": (B, S_cache, Hkv, D), "len":
(B,) int32}`` plus ``"slot_pos": (B, S_cache)`` for a ring.  A step writes
its keys and values into ``k``/``v`` in place and returns a dict with
new ``len`` (and ``slot_pos``) tensors.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import sharded
from repro_torch.models.layers import dense_init, param, rmsnorm, softcap

__all__ = ["Q_CHUNK", "rope", "Attention", "attn_forward", "init_attn_cache"]

Q_CHUNK = 1024


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,).  Rotates the two halves
    of the head (not interleaved pairs)."""
    d = x.shape[-1]
    half = d // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), expo)
    ang = positions[..., None].float() * freq                 # (B,S,half)
    cos = torch.cos(ang)[..., None, :]                        # (B,S,1,half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` and, with qk-norm, ``q_norm`` and
    ``k_norm``: the reference's ``attn_init`` dict, one field each."""

    def __init__(self, gen, cfg, dtype, device):
        super().__init__()
        d, hq, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim)
        self.wq = dense_init(gen, d, hq * dh, dtype, device)
        self.wk = dense_init(gen, d, hkv * dh, dtype, device)
        self.wv = dense_init(gen, d, hkv * dh, dtype, device)
        self.wo = dense_init(gen, hq * dh, d, dtype, device)
        if cfg.qk_norm:
            self.q_norm = param(torch.zeros(dh, dtype=dtype, device=device))
            self.k_norm = param(torch.zeros(dh, dtype=dtype, device=device))


def _sdpa(q, k, v, *, causal: bool, window: int, q_offset,
          logit_cap: float, kv_len=None, kpos=None):
    """q: (B,Sq,Hq,D); k,v: (B,Sk,Hkv,D); query head h reads kv head
    h // G.  Returns (B,Sq,Hq,D).

    q_offset: global position of q[0] (an int or a (B,) tensor).
    kv_len: number of valid cache entries, (B,) (a preallocated cache).
    kpos: absolute key positions (B,Sk) of a ring cache; < 0 is invalid.
    window: the band's width; 0 means global.
    On DTensors, shard by shard (``sharded.sdpa``).
    """
    if sharded.is_sharded(q):
        return sharded.sdpa(_sdpa, q, k, v, causal=causal, window=window,
                            q_offset=q_offset, logit_cap=logit_cap,
                            kv_len=kv_len, kpos=kpos)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    scale = D ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, D) * scale

    if kpos is None:
        kpos_b = torch.arange(Sk, device=dev)[None, :]
        valid_k = (kpos_b < kv_len[:, None]) if kv_len is not None \
            else torch.ones((1, Sk), dtype=torch.bool, device=dev)
    else:
        kpos_b = kpos
        valid_k = kpos_b >= 0
    kf, vf = k.float(), v.float()

    def chunk_attn(q_chunk, qpos):
        # q_chunk: (B,C,Hkv,G,D); qpos: (B,C); scores (B,C,Hkv,G,Sk)
        s = torch.einsum("bchgd,bkhd->bchgk", q_chunk.float(), kf)
        s = softcap(s, logit_cap)
        mask = valid_k[:, None, :].expand(valid_k.shape[0], qpos.shape[1],
                                          Sk)
        if causal:
            mask = mask & (kpos_b[:, None, :] <= qpos[:, :, None])
        if window > 0:
            mask = mask & (kpos_b[:, None, :] > (qpos[:, :, None] - window))
        s = torch.where(mask[:, :, None, None, :], s,
                        torch.tensor(-1e30, dtype=s.dtype, device=dev))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bchgk,bkhd->bchgd", p, vf).to(q.dtype)

    q_offset = torch.as_tensor(q_offset, device=dev).expand(B)
    if Sq <= Q_CHUNK:
        qpos = q_offset[:, None] + torch.arange(Sq, device=dev)[None, :]
        out = chunk_attn(qg, qpos)
    else:
        n_chunks = Sq // Q_CHUNK
        assert Sq % Q_CHUNK == 0, "pad sequence to the query chunk size"
        ar = torch.arange(Q_CHUNK, device=dev)[None, :]
        out = torch.cat([
            chunk_attn(qg[:, ci * Q_CHUNK:(ci + 1) * Q_CHUNK],
                       q_offset[:, None] + ci * Q_CHUNK + ar)
            for ci in range(n_chunks)], dim=1)
    return out.reshape(B, Sq, Hq, D)


def _split_heads(t: torch.Tensor, h: int, dh: int) -> torch.Tensor:
    """(B, S, h·dh) → (B, S, h, dh), a DTensor's shards made whole heads
    first."""
    t = sharded.whole_heads(t, h)
    return t.reshape(*t.shape[:-1], h, dh)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, h, dh) → (B, S, h·dh); a DTensor's gradient comes back in
    whole heads."""
    flat = t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])
    return sharded.whole_heads_grad(flat, t.shape[-2])


def attn_forward(p, cfg, x: torch.Tensor, *, local, positions: torch.Tensor,
                 cache: dict | None = None, norm_eps: float = 1e-6):
    """x: (B,S,d).  ``local``: this layer's window (0/False/None = global).

    Returns (y, new_cache).  Without a cache, positions are (S,) or
    (B,S).  With one, the step's keys land at ``cache["len"]`` (a linear
    cache) or at slot ``len % S_cache`` (a ring, S must be 1)."""
    B, S, d = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ p.wq, hq, dh)
    k = _split_heads(x @ p.wk, hkv, dh)
    v = _split_heads(x @ p.wv, hkv, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, norm_eps)
        k = rmsnorm(k, p.k_norm, norm_eps)
    pos_b = positions if positions.ndim == 2 else positions[None, :]
    q = rope(q, pos_b, cfg.rope_theta)
    k = rope(k, pos_b, cfg.rope_theta)

    window = 0 if local is False or local is None else int(local)
    new_cache = None
    if cache is None:
        off = positions[0] if positions.ndim == 1 else positions[:, 0]
        out = _sdpa(q, k, v, causal=cfg.causal, window=window,
                    q_offset=off, logit_cap=cfg.attn_logit_softcap)
    elif "slot_pos" in cache:
        # ring buffer: keys are cached post-RoPE; slot_pos holds absolute
        # positions so the causal/window masks survive wrap-around.
        S_cache = cache["k"].shape[1]
        idx = cache["len"]
        slot = idx % S_cache
        _batch_update(cache["k"], k, slot)
        _batch_update(cache["v"], v, slot)
        slot_pos = cache["slot_pos"].clone()
        # slot_pos[b, slot[b]] = idx[b]
        _batch_update(slot_pos, idx.to(torch.int32)[:, None], slot)
        out = _sdpa(q, cache["k"], cache["v"], causal=cfg.causal,
                    window=window, q_offset=idx,
                    logit_cap=cfg.attn_logit_softcap, kpos=slot_pos)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": idx + S,
                     "slot_pos": slot_pos}
    else:
        idx = cache["len"]
        _batch_update(cache["k"], k, idx)
        _batch_update(cache["v"], v, idx)
        new_len = idx + S
        out = _sdpa(q, cache["k"], cache["v"], causal=cfg.causal,
                    window=window, q_offset=idx,
                    logit_cap=cfg.attn_logit_softcap, kv_len=new_len)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": new_len}
    y = _merge_heads(out) @ p.wo
    return y, new_cache


def _batch_update(cache: torch.Tensor, new: torch.Tensor,
                  idx: torch.Tensor) -> None:
    """Write new (B,S,...) into cache (B,S_max,...) at per-row offset
    idx, in place.  The start is clamped to [0, S_max - S], as
    ``lax.dynamic_update_slice`` clamps it.  A DTensor cache is written
    shard by shard (``sharded.batch_update``)."""
    if sharded.is_sharded(cache):
        sharded.batch_update(_batch_update, cache, new, idx)
        return
    B, S = new.shape[0], new.shape[1]
    S_max = cache.shape[1]
    if S > S_max:
        raise ValueError(f"update of {S} rows does not fit a cache of "
                         f"{S_max}")
    start = idx.long().clamp(0, S_max - S)
    rows = start[:, None] + torch.arange(S, device=cache.device)[None, :]
    cache[torch.arange(B, device=cache.device)[:, None], rows] = \
        new.to(cache.dtype)


def init_attn_cache(cfg, B: int, S_max: int, dtype=torch.float32,
                    ring: bool = False, device=None) -> dict:
    """ring=True (sliding-window archs): the cache holds only ``window``
    slots."""
    S_cache = min(S_max, cfg.sliding_window) if ring and cfg.sliding_window \
        else S_max
    shape = (B, S_cache, cfg.num_kv_heads, cfg.head_dim)
    out = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((B,), dtype=torch.int32, device=device),
    }
    if ring and cfg.sliding_window and S_cache < S_max:
        out["slot_pos"] = torch.full((B, S_cache), -1, dtype=torch.int32,
                                     device=device)
    return out
