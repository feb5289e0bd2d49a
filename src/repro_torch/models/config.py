"""Model configuration shared by all assigned architectures.

The port keeps its own copy of the reference's ``models/config.py``
(a plain dataclass), so that it imports nothing of the JAX package."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple

__all__ = ["ModelConfig"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_experts_active: int = 0
    shared_d_ff: int = 0           # shared-expert FFN width (qwen2-moe)
    capacity_factor: float = 1.25

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- hybrid (recurrentgemma) ---------------------------------------------
    block_pattern: Tuple[str, ...] = ()  # per-layer: "attn" | "rglru" | "ssm"
    window: int = 0                      # local-attention window (0 = full)
    rglru_conv_width: int = 4

    # --- encoder-decoder (whisper) --------------------------------------------
    is_encdec: bool = False
    n_enc_layers: int = 0
    n_enc_tokens: int = 1500   # precomputed audio-frame embeddings (stub frontend)

    # --- multimodal stub frontend ----------------------------------------------
    frontend: str = "none"     # none | vit_stub | audio_stub
    n_frontend_tokens: int = 0  # image/patch tokens prepended to the sequence
    mlp_act: str = "swiglu"     # swiglu | gelu

    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 16 so the logits dim shards on the
        TP axis — the loss then runs on vocab-sharded logits instead of
        all-reducing a full f32 (B,S,V) tensor (DESIGN.md §5).
        Pad columns have zero weights; the loss and decode mask them."""
        return ((self.vocab_size + 15) // 16) * 16

    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def layer_kind(self, i: int) -> str:
        if not self.block_pattern:
            return "ssm" if self.family == "ssm" else "attn"
        return self.block_pattern[i % len(self.block_pattern)]

    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token decode (no full-attention KV scaling)?"""
        if self.family == "ssm":
            return True
        if self.block_pattern and self.window:
            return all(k != "attn" or self.window for k in self.block_pattern)
        return False

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        return replace(
            self,
            n_layers=min(self.n_layers, max(2, len(self.block_pattern))),
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=128,
            n_heads=4,
            # keep the GQA/MQA/MHA character but stay a divisor of 4 heads
            n_kv_heads=(
                0 if not self.n_kv_heads
                else 1 if self.n_kv_heads == 1
                else 2 if self.n_kv_heads < self.n_heads
                else 4
            ),
            head_dim=32,
            d_ff=256,
            shared_d_ff=256 if self.shared_d_ff else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 8),
            n_experts_active=min(self.n_experts_active, 2),
            ssm_state=min(self.ssm_state, 32),
            ssm_head_dim=32,
            ssm_chunk=32,
            window=min(self.window, 64) if self.window else 0,
            n_enc_tokens=min(self.n_enc_tokens, 32),
            n_frontend_tokens=min(self.n_frontend_tokens, 16),
        )

    # parameter-count estimate (for 6ND model-FLOPs accounting)
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.hd()
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.mlp_act == "swiglu":
            per_mlp = 3 * d * self.d_ff
        else:
            per_mlp = 2 * d * self.d_ff
        n_dec = self.n_layers
        total = emb
        for i in range(n_dec):
            kind = self.layer_kind(i)
            if kind == "attn":
                total += per_attn + 2 * d
            elif kind == "rglru":
                di = d  # rglru block width = d_model (proj in/out)
                total += 2 * d * di + di * self.rglru_conv_width + 3 * di * di // 1 + 2 * d
            elif kind == "ssm":
                d_in = self.ssm_expand * d
                nh = d_in // self.ssm_head_dim
                total += d * (2 * d_in + 2 * self.ssm_state + nh) + d_in * d + 2 * d
            if self.n_experts:
                e = self.n_experts_active if active_only else self.n_experts
                total += e * 3 * d * self.d_ff + d * self.n_experts
                if self.shared_d_ff:
                    total += 3 * d * self.shared_d_ff
            elif kind == "attn" or not self.block_pattern:
                total += per_mlp
            else:
                total += per_mlp
        if self.is_encdec:
            for _ in range(self.n_enc_layers):
                total += per_attn + per_mlp + 4 * d
            total += n_dec * (per_attn + 2 * d)  # cross-attention
        return total
