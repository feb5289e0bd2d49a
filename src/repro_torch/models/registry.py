"""Model API of the port over the dense decoder (counterpart of the
reference's ``models/registry.py``).  Only ``family="dense"`` models with
attention-only layers are ported; every other family raises
``NotImplementedError`` (ROADMAP Queue 1 item 11)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

__all__ = ["init_model", "make_cache", "apply_prefill", "apply_decode",
           "merge_prefill", "supports_batched_prefill"]


def _check_family(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.is_encdec or cfg.n_experts
            or cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name!r} (family {cfg.family!r}) is not ported yet: the "
            "port serves dense attention-only decoders; the rest of the zoo "
            "is ROADMAP Queue 1 item 11")


def supports_batched_prefill(cfg: ModelConfig) -> bool:
    """True for the dense attention-only decoders the port serves."""
    return (cfg.family == "dense" and not cfg.is_encdec
            and all(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers)))


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device="cuda") -> Params:
    """Random bf16 weights from a ``torch.Generator`` seeded with ``seed``
    on ``device``."""
    _check_family(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return transformer.init_params(gen, cfg, device=device)


def make_cache(params: Params, cfg: ModelConfig, batch_size: int,
               max_len: int, *, policy=None, kv_quant: bool = False,
               kv_layout: str = "ring", device="cuda") -> Params:
    """The ring decode cache on ``device``."""
    _check_family(cfg)
    return transformer.init_cache(cfg, batch_size, max_len, kv_quant=kv_quant,
                                  kv_layout=kv_layout, device=device)


def apply_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  lengths: torch.Tensor, max_len: int, *, policy=None,
                  counter=0, kv_quant: bool = False, kv_offset=None):
    """Batched prefill → (last-token logits (B, vocab_size), ring cache)."""
    _check_family(cfg)
    b, s = tokens.shape
    logits, cache = transformer.prefill_with_cache(
        params, cfg, tokens, lengths, max_len, policy=policy,
        counter=counter, kv_quant=kv_quant, kv_offset=kv_offset)
    last = torch.clamp(lengths.long() - 1, 0, s - 1)
    return logits[torch.arange(b, device=logits.device), last], cache


def apply_decode(params: Params, cfg: ModelConfig, token: torch.Tensor,
                 cache: Params, *, policy=None, counter=0, kv_offset=None,
                 backend: Optional[str] = None):
    """One decode step (``transformer.decode_step``)."""
    _check_family(cfg)
    return transformer.decode_step(params, cfg, token, cache, policy=policy,
                                   counter=counter, kv_offset=kv_offset,
                                   backend=backend)


def merge_prefill(cfg: ModelConfig, old: Params, new: Params,
                  active: torch.Tensor) -> Params:
    """Rows of ``new`` where ``active`` replace rows of ``old`` (in place)."""
    return transformer.merge_cache(old, new, active)
