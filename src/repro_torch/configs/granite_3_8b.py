"""Granite-3.0-8B [hf:ibm-granite]: 40L, d=4096, 32H GQA(kv=8), ff=12800, v=49155."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab_size=49155,
)
