"""Whisper-small [arXiv:2212.04356]: enc-dec, 12L+12L, d=768, 12H MHA(kv=12),
ff=3072, v=51865.  Conv audio frontend is a STUB (precomputed frame embeddings,
1500 frames = 30 s).  GELU MLPs, pre-LN.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865, mlp_act="gelu",
    is_encdec=True, n_enc_layers=12, n_enc_tokens=1500,
    frontend="audio_stub", tie_embeddings=True,
)
