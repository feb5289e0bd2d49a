"""Qwen1.5-MoE-A2.7B [hf:Qwen]: 24L, d=2048, 16H MHA(kv=16), 60 routed experts
top-4 + 4 shared (shared ff = 4x1408 = 5632), expert ff=1408, v=151936."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=151936, qkv_bias=True,
    n_experts=60, n_experts_active=4, shared_d_ff=5632,
)
