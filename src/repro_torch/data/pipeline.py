"""Deterministic synthetic data pipeline (no downloads): the port's
counterpart of the reference's ``data/pipeline.py``.

Token streams are a stateless hash of (seed, step, position): every host can
generate exactly its shard without coordination, restarts are reproducible
from the step counter alone (checkpoint stores only ``step``), and skew/
straggler behaviour is testable by construction.  The stream has real
next-token structure (a noisy Markov chain over the vocab) so losses move.
The hash is the port's ``core/rounding.hash_uniform``, bit for bit the
reference's, so both packages draw the same tokens, the VLM stub
frontend's patch embeddings and the audio stub frontend's frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import torch

from repro_torch.core.rounding import hash_uniform
from repro_torch.models.config import ModelConfig

__all__ = ["DataConfig", "synthetic_batch", "data_iterator"]


@dataclass(frozen=True)
class DataConfig:
    batch: int
    seq: int
    seed: int = 0
    markov_order: int = 1


def _positions(batch: int, seq: int, device) -> torch.Tensor:
    return torch.arange(batch * seq, dtype=torch.int64,
                        device=device).reshape(batch, seq)


def _hash_tokens(seed: int, step: int, batch: int, seq: int, vocab: int,
                 device) -> torch.Tensor:
    """Base stream: u = hash(seed, flat index, step) → token ids."""
    u = hash_uniform(seed, _positions(batch, seq, device), step)
    return (u * vocab).to(torch.int32) % vocab


def synthetic_batch(cfg: ModelConfig, dcfg: DataConfig, step: int,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """One global batch of int32 tokens on ``device``.  Markov structure:
    token_{t+1} ≡ token_t + drift (mod V) with probability 0.75, else
    uniform — learnable but non-trivial.  A ``vit_stub`` config also gets
    ``embeds`` (B, F, d) bf16 and an encoder-decoder ``frames`` (B, T_enc,
    d) bf16: one hashed block in [-0.5, 0.5) (seeds ``seed ^ 0xF00D`` and
    ``seed ^ 0xFEED``), the same for every row, as the reference's."""
    vocab = cfg.vocab_size
    base = _hash_tokens(dcfg.seed, step, dcfg.batch, dcfg.seq, vocab, device)
    idx = _positions(dcfg.batch, dcfg.seq, device)
    keep = hash_uniform(dcfg.seed ^ 0xBEEF, idx, step) < 0.75
    drift = (torch.arange(dcfg.seq, dtype=torch.int32, device=device)
             * 7919) % vocab
    markov = (base[:, :1] + drift[None, :]) % vocab
    tokens = torch.where(keep, markov, base)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.frontend == "vit_stub":
        batch["embeds"] = _stub(dcfg, step, 0xF00D, cfg.n_frontend_tokens,
                                cfg.d_model, device)
    if cfg.is_encdec:
        batch["frames"] = _stub(dcfg, step, 0xFEED, cfg.n_enc_tokens,
                                cfg.d_model, device)
    return batch


def _stub(dcfg: DataConfig, step: int, salt: int, n: int, d: int,
          device) -> torch.Tensor:
    """A stub frontend's (B, n, d) bf16 rows: u - 0.5 of the hash of
    (seed ^ salt, flat index, step) over one (n, d) block, broadcast over
    the batch."""
    f = torch.arange(n * d, dtype=torch.int64, device=device)
    u = hash_uniform(dcfg.seed ^ salt, f, step).reshape(1, n, d)
    return (u - 0.5).to(torch.bfloat16).expand(dcfg.batch, n, d)


def data_iterator(cfg: ModelConfig, dcfg: DataConfig, start_step: int = 0,
                  device="cuda") -> Iterator:
    step = start_step
    while True:
        yield synthetic_batch(cfg, dcfg, step, device=device)
        step += 1
