"""RecurrentGemma-9B [arXiv:2402.19427]: 38L, d=4096, 16H MQA(kv=1), ff=12288,
v=256000.  RG-LRU + local attention, pattern (rec, rec, attn) = 1 attn : 2 rec,
window 2048.  Sub-quadratic -> serves long_500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000, mlp_act="gelu",
    block_pattern=("rglru", "rglru", "attn"), window=2048,
)
