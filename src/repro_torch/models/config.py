"""Unified architecture configuration for the 10 assigned architectures.

A copy of the JAX package's ``ArchConfig`` without ``kernel_mode``: in this
package the device of a tensor, not a config field, decides whether a kernel
or its plain version runs."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0            # 0 for attention-free archs
    n_kv_heads: int = 0
    head_dim: int = 128
    d_ff: int = 0
    vocab: int = 32000
    mlp_act: str = "swiglu"     # swiglu | gelu

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_dense_ff: int = 0       # arctic: parallel dense-FFN residual branch
    shared_expert_ff: int = 0   # llama4: always-on shared expert
    capacity_factor: float = 1.25

    # --- attention pattern ---
    sliding_window: int = 0     # >0: window size for local layers
    global_every: int = 0       # gemma3: every k-th layer is global

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (zamba2): shared attn+mlp block every `attn_every` layers
    attn_every: int = 0

    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_len: int = 0            # encoder frames (stub embeddings)

    # --- VLM (llava) ---
    n_patches: int = 0          # patch embeddings prepended (stub)

    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "none"         # none | full | dots

    # ------------------------------------------------------------- derived
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    def is_global_layer(self, i: int) -> bool:
        """gemma3-style 5 local : 1 global pattern."""
        if self.global_every <= 0 or self.sliding_window <= 0:
            return True
        return (i + 1) % self.global_every == 0

    def is_attn_layer(self, i: int) -> bool:
        """zamba2-style: shared attention block every `attn_every` layers."""
        if self.attn_every <= 0:
            return False
        return (i + 1) % self.attn_every == 0

    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape (DESIGN.md §4)."""
        return self.family in ("ssm", "hybrid") or (
            self.sliding_window > 0 and self.global_every > 0)

    def has_decode(self) -> bool:
        return True   # all assigned archs are decoders or enc-dec

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # Active parameters per token (for MODEL_FLOPS = 6 * N_active * D)
    def param_counts(self) -> dict[str, float]:
        d, hd = self.d_model, self.head_dim
        h, k = self.n_heads, self.n_kv_heads
        att = d * h * hd + 2 * d * k * hd + h * hd * d if h else 0
        if self.mlp_act == "swiglu":
            mlp_per_ff = 3 * d
        else:
            mlp_per_ff = 2 * d
        layer_dense = 0.0
        layer_active = 0.0
        layer_total = 0.0
        if self.family in ("ssm",):
            di, st = self.d_inner, self.ssm_state
            # in_proj: d -> 2*di + 2*ngroups*state + nheads ; out_proj di->d
            ssm = d * (2 * di + 2 * st + self.ssm_heads) + di * d
            layer_total = layer_active = ssm
        elif self.family == "hybrid":
            di, st = self.d_inner, self.ssm_state
            ssm = d * (2 * di + 2 * st + self.ssm_heads) + di * d
            layer_total = layer_active = ssm
            n_attn = self.n_layers // max(self.attn_every, 1)
            shared = att + mlp_per_ff * self.d_ff
            # shared block params counted once, applied n_attn times
            extra_total = shared
            extra_active = shared * n_attn / self.n_layers
            layer_total += extra_total / self.n_layers
            layer_active += extra_active
        else:
            layer_total = layer_active = att
            if self.n_experts:
                layer_total += self.n_experts * mlp_per_ff * self.d_ff
                layer_active += self.top_k * mlp_per_ff * self.d_ff
                if self.moe_dense_ff:
                    layer_total += mlp_per_ff * self.moe_dense_ff
                    layer_active += mlp_per_ff * self.moe_dense_ff
                if self.shared_expert_ff:
                    layer_total += mlp_per_ff * self.shared_expert_ff
                    layer_active += mlp_per_ff * self.shared_expert_ff
            else:
                layer_total += mlp_per_ff * self.d_ff
                layer_active += mlp_per_ff * self.d_ff
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        enc = 0.0
        if self.family == "encdec":
            enc_att = att
            enc_mlp = mlp_per_ff * self.d_ff
            cross = att
            enc = self.enc_layers * (enc_att + enc_mlp)
            layer_total += cross
            layer_active += cross
        total = embed + self.n_layers * layer_total + enc
        active = embed + self.n_layers * layer_active + enc
        return {"total": total, "active": active}
