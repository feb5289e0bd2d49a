"""MiniCPM-2B [arXiv:2404.06395]: 40L, d=2304, 36H MHA(kv=36), ff=5760, v=122753.

Llama-like arch; trained with the WSD schedule (optim/schedules.py provides it).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, head_dim=64,
    d_ff=5760, vocab_size=122753, tie_embeddings=True,
)
