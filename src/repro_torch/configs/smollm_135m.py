"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M]: 30L, d=576, 9H GQA(kv=3), ff=1536, v=49152."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab_size=49152, tie_embeddings=True,
)
