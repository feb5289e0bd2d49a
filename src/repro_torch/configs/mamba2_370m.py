"""Mamba2-370M [arXiv:2405.21060]: 48L, d=1024, attn-free SSD, state=128.

d_inner = 2*d = 2048, head_dim 64 -> 32 SSD heads. Sub-quadratic -> long_500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280, tie_embeddings=True,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    block_pattern=("ssm",),
)
