"""Qwen2-1.5B [arXiv:2407.10671]: 28L, d=1536, 12H GQA(kv=2), ff=8960, v=151936.

GQA with QKV bias, SwiGLU, tied embeddings (Qwen2-1.5B ties lm_head).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6,
)
