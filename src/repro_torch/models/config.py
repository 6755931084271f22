"""Architecture configuration for the assigned-architecture zoo.

One frozen dataclass covers all six families (dense / moe / ssm / hybrid /
audio / vlm); per-layer block layout is derived by :meth:`layer_kinds`.
Every field maps to a published architecture knob; configs cite sources in
``src/repro_torch/configs/<arch>.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = ["ModelConfig"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                  # query heads (0 → attention-free)
    num_kv_heads: int
    head_dim: int
    d_ff: int                       # dense-MLP hidden (per gate branch)
    vocab_size: int

    # --- attention flavour --------------------------------------------------
    rope_theta: float = 10_000.0
    qk_norm: bool = False           # qwen3
    attn_logit_softcap: float = 0.0   # gemma2 (0 = off)
    final_logit_softcap: float = 0.0  # gemma2 (0 = off)
    sliding_window: int = 0         # window size for local layers (0 = off)
    local_global_alternating: bool = False  # gemma2 layer pattern
    causal: bool = True             # False → encoder-only (hubert)
    activation: str = "swiglu"      # swiglu | geglu | gelu

    # --- MoE ------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0               # per-expert hidden
    first_k_dense: int = 0          # leading dense layers (deepseek-moe)
    router_aux_coef: float = 0.01   # load-balance loss weight

    # --- SSM (Mamba2 / SSD) -----------------------------------------------------
    ssm_state: int = 0              # d_state (0 = no ssm layers)
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    attn_every: int = 0             # hybrid: attention block every k layers
                                    # (zamba2-style shared block)

    # --- modality frontends (stubs per spec) ------------------------------------
    modality: str = "text"          # text | audio_frames | image_patches
    frontend_tokens: int = 0        # patch/frame count prepended (vlm)
    frontend_dim: int = 0           # embedding dim delivered by the stub

    # --- misc -------------------------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    source: str = ""                # citation

    # ------------------------------------------------------------------ helpers
    @property
    def attention_free(self) -> bool:
        return self.num_heads == 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kinds(self) -> list[str]:
        """Mixer kind per layer: 'attn' | 'attn_local' | 'ssm'."""
        kinds = []
        for i in range(self.num_layers):
            if self.arch_type in ("ssm",):
                kinds.append("ssm")
            elif self.arch_type == "hybrid":
                if self.attn_every and (i + 1) % self.attn_every == 0:
                    kinds.append("attn")
                else:
                    kinds.append("ssm")
            elif self.local_global_alternating:
                kinds.append("attn_local" if i % 2 == 0 else "attn")
            elif self.sliding_window:
                kinds.append("attn_local")
            else:
                kinds.append("attn")
        return kinds

    def mlp_kinds(self) -> list[str]:
        """'moe' | 'dense' | 'none' per layer."""
        out = []
        for i in range(self.num_layers):
            if self.arch_type in ("ssm", "hybrid"):
                # mamba2 blocks have no MLP; zamba2's MLP lives in the
                # *shared* attention block (applied every attn_every layers)
                out.append("none")
            elif self.num_experts and i >= self.first_k_dense:
                out.append("moe")
            else:
                out.append("dense")
        return out

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (DESIGN.md §5 policy)."""
        return (self.arch_type in ("ssm", "hybrid")
                or self.sliding_window > 0 or self.local_global_alternating)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    # ------------------------------------------------------------------ variants
    def smoke(self) -> "ModelConfig":
        """Reduced same-family variant: ≤2 layers, d_model ≤ 512, ≤4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = 0 if self.attention_free else min(self.num_heads, 4)
        n_kv = 0 if self.attention_free else min(
            self.num_kv_heads, max(1, n_heads // 2))
        changes = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=0 if self.attention_free else 32,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            first_k_dense=min(self.first_k_dense, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            attn_every=2 if self.attn_every else 0,
            frontend_tokens=min(self.frontend_tokens, 8) if self.frontend_tokens else 0,
            frontend_dim=d_model if self.frontend_dim else 0,
        )
        return dataclasses.replace(self, **changes)

    def with_long_context(self, window: int = 4096) -> "ModelConfig":
        """Sliding-window variant for long_500k on dense archs (DESIGN §5)."""
        if self.arch_type in ("ssm", "hybrid"):
            return self
        return dataclasses.replace(self, sliding_window=window,
                                   local_global_alternating=False,
                                   name=self.name + "-sw")

    # ------------------------------------------------------------------ sizing
    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # unembed
        kinds, mlps = self.layer_kinds(), self.mlp_kinds()
        for kind, mlp in zip(kinds, mlps):
            if kind.startswith("attn"):
                q = self.num_heads * self.head_dim
                kv = self.num_kv_heads * self.head_dim
                n += d * q + 2 * d * kv + q * d       # qkv + o
                if self.qk_norm:
                    n += 2 * self.head_dim
            else:                                     # ssm (mamba2)
                di = self.d_inner
                # in_proj: d -> (2*di + 2*d_state + heads); out: di -> d
                n += d * (2 * di + 2 * self.ssm_state + self.ssm_heads)
                n += di * d
                n += self.ssm_conv_width * (di + 2 * self.ssm_state)
                n += 2 * self.ssm_heads               # A_log, dt_bias
            if mlp == "dense":
                gate = 2 if self.activation in ("swiglu", "geglu") else 1
                ff = self.d_ff
                n += d * ff * gate + ff * d
            elif mlp == "moe":
                gate = 2 if self.activation in ("swiglu", "geglu") else 1
                per = self.d_model * self.moe_d_ff * (gate + 1)
                n += self.num_experts * per
                n += self.num_shared_experts * per
                n += d * self.num_experts             # router
            n += 2 * d                                # 2 rmsnorm scales
        if self.arch_type == "hybrid" and self.attn_every:
            # one shared attention+MLP block (zamba2 design)
            q = self.num_heads * self.head_dim
            kv = self.num_kv_heads * self.head_dim
            gate = 2 if self.activation in ("swiglu", "geglu") else 1
            n += d * q + 2 * d * kv + q * d
            n += d * self.d_ff * gate + self.d_ff * d
            n += 2 * d
        n += d                                        # final norm
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared only)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        gate = 2 if self.activation in ("swiglu", "geglu") else 1
        per = self.d_model * self.moe_d_ff * (gate + 1)
        moe_layers = sum(1 for m in self.mlp_kinds() if m == "moe")
        inactive = moe_layers * (self.num_experts
                                 - self.experts_per_token) * per
        return full - inactive
