"""Granite-3.0-1B-A400M [hf:ibm-granite]: 24L, d=1024, 16H GQA(kv=8),
32 experts top-8, expert ff=512, v=49155."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    n_experts=32, n_experts_active=8,
)
