"""Mamba2 / SSD mixer (``repro/models/ssm.py``, arXiv:2405.21060).

Within a chunk of length Q the recurrence

    h_t = a_t · h_{t-1} + Δt_t · B_t ⊗ x_t,     y_t = C_t · h_t + D · x_t

is taken as a masked, decay-weighted quadratic form; across chunks only
the (H, P, N) state is carried, by a Python loop over the chunks.
Decode is the one-step recurrence on an explicit ``{"conv", "ssm"}``
cache; a prompt run with a cache continues from the cached state.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import sharded
from repro_torch.models.layers import dense_init, param, rmsnorm

__all__ = ["CHUNK", "SSM", "ssm_forward", "init_ssm_cache"]

CHUNK = 256


class SSM(nn.Module):
    """The reference's ``ssm_init`` dict, one field each.  ``in_proj``
    packs [z (di), xBC (di + 2N), dt (H)]."""

    def __init__(self, gen, cfg, dtype, device):
        super().__init__()
        d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_dim = di + 2 * N
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = dense_init(gen, d, 2 * di + 2 * N + H, dtype, device)
        conv_w = torch.empty((cfg.ssm_conv_width, conv_dim), **f32)
        nn.init.normal_(conv_w, generator=gen)
        self.conv_w = param((conv_w * 0.1).to(dtype))
        self.conv_b = param(torch.zeros(conv_dim, dtype=dtype, device=device))
        self.A_log = param(torch.zeros(H, **f32))         # A = -exp(A_log)
        self.dt_bias = param(torch.full((H,), -2.0, **f32))
        self.D = param(torch.ones(H, **f32))
        self.gate_norm = param(torch.zeros(di, dtype=dtype, device=device))
        self.out_proj = dense_init(gen, di, d, dtype, device)


def _split_proj(cfg, proj):
    di, N = cfg.d_inner, cfg.ssm_state
    return (proj[..., :di], proj[..., di:2 * di + 2 * N],
            proj[..., 2 * di + 2 * N:])


def _causal_conv(xBC, w, b):
    """Depthwise causal conv along S. xBC: (B,S,C); w: (W,C).  On
    DTensors, shard by shard (``sharded.causal_conv``)."""
    if sharded.is_sharded(xBC):
        return sharded.causal_conv(_causal_conv, xBC, w, b)
    W, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(W))
    return F.silu(out + b)


def _segsum_decay(log_a):
    """log_a: (..., Q).  L[i, j] = sum_{j < s <= i} log_a_s for i >= j,
    -inf above the diagonal."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    L = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=log_a.device))
    return L.masked_fill(~mask, float("-inf"))


def ssm_forward(p, cfg, x: torch.Tensor, cache: dict | None = None):
    """x: (B,S,d) → ((B,S,d), new_cache); cache = {"conv": (B,W-1,C),
    "ssm": (B,H,P,N)}."""
    B, S, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC, dt = _split_proj(cfg, sharded.pin_grad(x @ p.in_proj))

    new_cache = None
    if cache is None:
        xBC = _causal_conv(xBC, p.conv_w, p.conv_b)
    else:
        # the conv reads the stored W-1 history instead of zero padding
        W = cfg.ssm_conv_width
        hist = torch.cat([cache["conv"], xBC.to(cache["conv"].dtype)], 1)
        conv_cache = hist[:, -(W - 1):, :]
        out = sum(hist[:, i:i + S, :] * p.conv_w[i] for i in range(W))
        xBC = F.silu(out + p.conv_b)

    xh = xBC[..., :di].reshape(B, S, H, P)
    Bmat = xBC[..., di:di + N]
    Cmat = xBC[..., di + N:]
    dt = F.softplus(dt.float() + p.dt_bias)              # (B,S,H)
    A = -torch.exp(p.A_log)
    log_a = dt * A                                       # ≤ 0

    if cache is None:
        y, _ = _ssd_chunked(xh, Bmat, Cmat, dt, log_a, p.D, H, P, N,
                            torch.zeros((B, H, P, N), dtype=torch.float32,
                                        device=x.device))
    elif S == 1:
        h = cache["ssm"]
        a = torch.exp(log_a[:, 0])                       # (B,H)
        inp = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0], xh[:, 0].float(),
                           Bmat[:, 0].float())
        h = a[..., None, None] * h + inp
        y = torch.einsum("bhpn,bn->bhp", h, Cmat[:, 0].float())
        y = y + p.D[None, :, None] * xh[:, 0]
        y = y.reshape(B, 1, di)
        new_cache = {"conv": conv_cache, "ssm": h}
    else:
        y, h = _ssd_chunked(xh, Bmat, Cmat, dt, log_a, p.D, H, P, N,
                            cache["ssm"])
        new_cache = {"conv": conv_cache, "ssm": h}

    y = rmsnorm(y.reshape(B, S, di) * F.silu(z), p.gate_norm, cfg.norm_eps)
    return y.to(p.out_proj.dtype) @ p.out_proj, new_cache


def _ssd_chunked(xh, Bmat, Cmat, dt, log_a, D, H, P, N, h0):
    """Chunked SSD over whole sequences.  xh (B,S,H,P), B/C (B,S,N),
    dt/log_a (B,S,H); h0 (B,H,P,N).  Returns (y (B,S,H*P), h_final).
    On DTensors, shard by shard (``sharded.ssd``)."""
    if sharded.is_sharded(xh):
        return sharded.ssd(functools.partial(_ssd_chunked, P=P, N=N),
                           xh, Bmat, Cmat, dt, log_a, D, h0)
    B, S = xh.shape[0], xh.shape[1]
    Q = min(CHUNK, S)
    assert S % Q == 0, "pad sequence to the SSD chunk size"
    h = h0.float()
    ys = []
    for c0 in range(0, S, Q):
        xq = xh[:, c0:c0 + Q].float()
        bq = Bmat[:, c0:c0 + Q].float()
        cq = Cmat[:, c0:c0 + Q].float()
        dtq, laq = dt[:, c0:c0 + Q], log_a[:, c0:c0 + Q]
        # intra-chunk quadratic form
        L = _segsum_decay(laq.transpose(1, 2))           # (B,H,Q,Q)
        G = torch.einsum("bin,bjn->bij", cq, bq)         # (B,Q,Q)
        M = G[:, None] * torch.exp(L) * dtq.transpose(1, 2)[:, :, None, :]
        y = torch.einsum("bhij,bjhp->bihp", M, xq)       # (B,Q,H,P)
        # inter-chunk: the carried state's contribution
        decay_in = torch.exp(torch.cumsum(laq, dim=1))   # (B,Q,H)
        y = y + torch.einsum("bin,bih,bhpn->bihp", cq, decay_in, h)
        total = decay_in[:, -1]                          # (B,H)
        decay_out = torch.exp(
            torch.cumsum(laq.flip(1), dim=1).flip(1) - laq)
        upd = torch.einsum("bjh,bjhp,bjn->bhpn", dtq * decay_out, xq, bq)
        h = total[..., None, None] * h + upd
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + D[None, None, :, None] * xh
    return y.reshape(B, S, H * P).to(xh.dtype), h


def init_ssm_cache(cfg, B: int, dtype=torch.float32, device=None) -> dict:
    di, N = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((B, cfg.ssm_conv_width - 1, di + 2 * N),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((B, cfg.ssm_heads, cfg.ssm_head_dim, N),
                           dtype=torch.float32, device=device),
    }
