"""InternVL2-1B [arXiv:2404.16821]: Qwen2-0.5B LM backbone (24L, d=896, 14H
GQA(kv=2), ff=4864, v=151655) + InternViT frontend (STUB: input_specs provides
256 precomputed patch embeddings per image).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151655, qkv_bias=True, tie_embeddings=True,
    frontend="vit_stub", n_frontend_tokens=256, rope_theta=1e6,
)
