"""Model API of the port over every family (counterpart of the
reference's ``models/registry.py``): training's full-sequence logits and
the serving entry points, hiding the decoder-only vs encoder-decoder
split, and ``batch_spec``, the shapes of a training batch.  Batches are
dicts: ``tokens`` (B, S), and ``embeds`` (B, F, d) (the
VLM stub frontend's, prepended in ``apply_model``) or ``frames`` (B,
T_enc, d) (the audio stub frontend's, the encoder-decoder's input).

Models with recurrent state (SSD, RG-LRU) and the encoder-decoder prefill
by the reference's *scanned* prefill: one decode step per prompt position
over a fresh cache (the encoder-decoder's carrying its cross-KV), each
row frozen once its prompt ends (``apply_prefill``;
``scanned_prefill_step`` is one step of it, which the engine captures as
a CUDA graph on the card)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

__all__ = ["init_model", "apply_model", "make_cache", "apply_prefill",
           "scanned_prefill_step", "apply_prefill_paged",
           "apply_prefill_chunked", "apply_decode", "apply_verify",
           "verify_row_purity", "spec_commit", "merge_prefill",
           "supports_batched_prefill", "supports_paged_kv",
           "supports_chunked_prefill", "supports_spec_decode", "batch_spec"]


FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name!r}: unknown family {cfg.family!r}; "
                         f"the port has {FAMILIES}")


def supports_batched_prefill(cfg: ModelConfig) -> bool:
    """True when prompts can prefill in one batched forward that also
    emits the decode cache: attention-only decoders (the reference's
    definition).  SSD and RG-LRU layers carry recurrent state whose value
    at each row's prompt end the full-sequence pass does not give, and the
    encoder-decoder shares that path: they prefill by the scanned prefill
    (``apply_prefill``)."""
    return (not cfg.is_encdec
            and all(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers)))


def supports_paged_kv(cfg: ModelConfig) -> bool:
    """True when the arch can serve from the paged block-pool KV cache
    (DESIGN.md §6): attention-only decoders, as for batched prefill."""
    return supports_batched_prefill(cfg)


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """True when prompts can prefill in block-aligned or ring chunks spread
    over several engine steps (DESIGN.md §11): attention-only decoders.
    Recurrent layers would need their state checkpointed at every chunk
    boundary."""
    return supports_batched_prefill(cfg)


def supports_spec_decode(cfg: ModelConfig) -> bool:
    """True when draft-and-verify decode (DESIGN.md §14) keeps the bitwise
    stream contract: attention-only decoders without MoE.  SSM / RG-LRU
    recurrences have no multi-token verify form, and MoE capacity ranks are
    a cumsum over every token of a dispatch, so a verify row would compete
    for expert capacity with its own future draft positions."""
    return supports_batched_prefill(cfg) and not cfg.n_experts


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device="cuda") -> Params:
    """Random bf16 weights from a ``torch.Generator`` seeded with ``seed``
    on ``device``."""
    _check_family(cfg)
    # meta tensors (the dry run) draw nothing: a CPU generator serves
    gen = torch.Generator(device="cpu" if torch.device(device).type ==
                          "meta" else device)
    gen.manual_seed(seed)
    if cfg.is_encdec:
        return encdec.init_encdec(gen, cfg, device=device)
    return transformer.init_params(gen, cfg, device=device)


def apply_model(params: Params, cfg: ModelConfig,
                batch: Dict[str, torch.Tensor], *, policy=None, counter=0,
                remat: bool = True) -> torch.Tensor:
    """Full-sequence f32 logits (B, F + S, vocab_padded) for training and
    logits-only prefill (``transformer.forward``), with ``batch["embeds"]``
    (B, F, d) prepended where given (the VLM stub frontend); the
    encoder-decoder's (B, S, vocab_padded) over ``batch["frames"]``
    (``encdec.forward_encdec``).

    Under ``dist.ctx.train_shard_scope`` (the training mesh) params are
    this rank's blocks and the batch its data shard's rows, every family
    on any ('data', 'model') mesh."""
    _check_family(cfg)
    if cfg.is_encdec:
        return encdec.forward_encdec(params, cfg, batch["tokens"],
                                     batch["frames"], policy=policy,
                                     counter=counter, remat=remat)
    return transformer.forward(params, cfg, batch["tokens"],
                               embeds=batch.get("embeds"), policy=policy,
                               counter=counter, remat=remat)


def make_cache(params: Params, cfg: ModelConfig, batch_size: int,
               max_len: int, frames: Optional[torch.Tensor] = None, *,
               policy=None, kv_quant: bool = False,
               kv_layout: str = "ring", block_size: Optional[int] = None,
               num_blocks: Optional[int] = None, device="cuda",
               cross: Optional[Params] = None,
               data_shards: int = 1) -> Params:
    """The ring or paged decode cache on ``device``.  ``data_shards`` > 1
    lays the paged pool out as the reference's sharded engine holds it:
    shard-local sub-pools (one trash block each), ``num_blocks`` counting
    blocks per shard (DESIGN.md §9); a ring needs no layout change.  The
    encoder-decoder's is a ring with the cross-KV of ``frames`` (B, T_enc,
    d), the encoder run under ``policy`` (``encdec.init_encdec_cache``),
    or sharing ``cross``, another cache's cross-KV; its self-KV is bf16
    whatever ``kv_quant`` says, as the reference's."""
    _check_family(cfg)
    if cfg.is_encdec:
        if kv_layout != "ring":
            raise ValueError("paged KV layout requires an attention-only "
                             "decoder (see supports_paged_kv)")
        return encdec.init_encdec_cache(params, cfg, frames, batch_size,
                                        max_len, policy=policy, cross=cross,
                                        device=device)
    if kv_layout != "ring" and not supports_paged_kv(cfg):
        raise ValueError("paged KV layout requires an attention-only decoder "
                         f"(arch {cfg.name!r} has recurrent state)")
    return transformer.init_cache(cfg, batch_size, max_len, kv_quant=kv_quant,
                                  kv_layout=kv_layout, block_size=block_size,
                                  num_blocks=num_blocks, device=device,
                                  data_shards=data_shards)


def apply_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  lengths: torch.Tensor, max_len: int, *, policy=None,
                  counter=0, kv_quant: bool = False, kv_offset=None,
                  cache0: Optional[Params] = None,
                  frames: Optional[torch.Tensor] = None,
                  attn_block: Optional[tuple] = None):
    """Batched prefill of right-padded prompts (B, S) with true lengths
    (B,) (0: an inactive row) → (last-token logits (B, vocab_size) f32,
    ring cache with ``pos == lengths``).

    Attention-only decoders run ``transformer.prefill_with_cache``, one
    forward.  Models with recurrent state and the encoder-decoder run the
    reference's scanned prefill: from ``cache0`` (default a fresh cache,
    the encoder-decoder's from ``frames``; it is updated in place), one
    decode step per position t < S on the column ``tokens[:, t]``, each
    row's state, KV and position frozen once t ≥ its length
    (``scanned_prefill_step``, at the ring tile ``attn_block``), its
    logits kept from its last active step."""
    _check_family(cfg)
    b, s = tokens.shape
    lengths = lengths.to(torch.int32)
    if supports_batched_prefill(cfg):
        logits, cache = transformer.prefill_with_cache(
            params, cfg, tokens, lengths, max_len, policy=policy,
            counter=counter, kv_quant=kv_quant, kv_offset=kv_offset)
        last = torch.clamp(lengths.long() - 1, 0, s - 1)
        return logits[torch.arange(b, device=logits.device), last], cache
    cache = cache0 if cache0 is not None else make_cache(
        params, cfg, b, max_len, frames, policy=policy, kv_quant=kv_quant,
        device=tokens.device)
    last = torch.zeros((b, cfg.vocab_size), dtype=torch.float32,
                       device=tokens.device)
    for t in range(s):
        scanned_prefill_step(params, cfg, tokens[:, t], t, lengths, cache,
                             last, policy=policy, counter=counter,
                             kv_offset=kv_offset, attn_block=attn_block)
    return last, cache


def scanned_prefill_step(params: Params, cfg: ModelConfig,
                         token: torch.Tensor, t, lengths: torch.Tensor,
                         cache: Params, last: torch.Tensor, *, policy=None,
                         counter=0, kv_offset=None,
                         attn_block: Optional[tuple] = None) -> None:
    """Step t of the scanned prefill, in place: the decode step on
    ``token`` (B,) for the rows with t < ``lengths`` (the others keep
    their state, KV and position), and their logits into ``last`` (B,
    vocab_size).  ``t`` may be a device scalar (a captured step reads it
    there)."""
    active = lengths > t
    logits, new = apply_decode(
        params, cfg, token, cache, policy=policy, counter=counter,
        kv_offset=kv_offset, active=active, attn_block=attn_block)
    cache["pos"].copy_(torch.where(active, new["pos"], cache["pos"]))
    last.copy_(torch.where(active[:, None], logits, last))


def apply_prefill_paged(params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, lengths: torch.Tensor,
                        starts: torch.Tensor, block_tables: torch.Tensor,
                        cache: Params, *, policy=None, counter=0,
                        kv_quant: bool = False, kv_offset=None,
                        prefix_blocks: int = 0):
    """Paged batched prefill → (last-suffix-token logits (B, vocab_size),
    the live cache with the suffix blocks written in place).  Prefix-hit
    rows (``starts > 0``) skip recomputing the shared prefix — its K/V is
    gathered from the refcounted pool blocks inside attention."""
    _check_family(cfg)
    b, s = tokens.shape
    lengths = lengths.to(torch.int32)
    logits, cache = transformer.prefill_with_cache_paged(
        params, cfg, tokens, lengths, starts, block_tables, cache,
        policy=policy, counter=counter, kv_quant=kv_quant,
        kv_offset=kv_offset, prefix_blocks=prefix_blocks)
    last = torch.clamp(lengths.long() - 1, 0, s - 1)
    return logits[torch.arange(b, device=logits.device), last], cache


def apply_prefill_chunked(params: Params, cfg: ModelConfig,
                          tokens: torch.Tensor, lengths: torch.Tensor,
                          starts: torch.Tensor, cache: Params, *,
                          policy=None, counter=0, kv_quant: bool = False,
                          kv_offset=None):
    """Chunked ring prefill → (last-chunk-token logits (B, vocab_size), the
    live cache with the chunk K/V merged in place).  Continuation chunks
    (``starts > 0``) read their slot's earlier positions back from the
    ring inside attention instead of recomputing them (DESIGN.md §11)."""
    _check_family(cfg)
    b, s = tokens.shape
    lengths = lengths.to(torch.int32)
    logits, cache = transformer.prefill_with_cache_chunked(
        params, cfg, tokens, lengths, starts, cache, policy=policy,
        counter=counter, kv_quant=kv_quant, kv_offset=kv_offset)
    last = torch.clamp(lengths.long() - 1, 0, s - 1)
    return logits[torch.arange(b, device=logits.device), last], cache


def apply_decode(params: Params, cfg: ModelConfig, token: torch.Tensor,
                 cache: Params, *, policy=None, counter=0, kv_offset=None,
                 backend: Optional[str] = None, active=None,
                 attn_block: Optional[tuple] = None):
    """One decode step (``transformer.decode_step``), ring or paged by the
    cache's layout, or the encoder-decoder's (``encdec.decode_step_encdec``);
    rows where ``active`` (B,) is False keep their recurrent state and
    ring contents.  ``attn_block``: the ring attention kernel's tile (None:
    the dispatcher's default)."""
    _check_family(cfg)
    if cfg.is_encdec:
        return encdec.decode_step_encdec(
            params, cfg, token, cache, policy=policy, counter=counter,
            kv_offset=kv_offset, backend=backend, active=active,
            attn_block=attn_block)
    return transformer.decode_step(params, cfg, token, cache, policy=policy,
                                   counter=counter, kv_offset=kv_offset,
                                   backend=backend, active=active,
                                   attn_block=attn_block)


def apply_verify(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 cache: Params, *, policy=None, counter=0, kv_offset=None,
                 alive=None, wcap=None, backend: Optional[str] = None,
                 fused_ops=frozenset(), attn_block: Optional[tuple] = None):
    """Score K draft positions per slot in one forward
    (``transformer.verify_step``); requires ``supports_spec_decode(cfg)``.
    ``fused_ops``: the library ops ``verify_row_purity`` found row-pure;
    ``attn_block``: the ring tile, ``apply_decode``'s."""
    _check_family(cfg)
    return transformer.verify_step(params, cfg, tokens, cache, policy=policy,
                                   counter=counter, kv_offset=kv_offset,
                                   alive=alive, wcap=wcap, backend=backend,
                                   fused_ops=fused_ops, attn_block=attn_block)


def verify_row_purity(params: Params, cfg: ModelConfig, batch: int,
                      kq: int) -> Dict[str, int]:
    """Per library op of the verify forward, the outputs in which running
    it over (batch, kq) rows at once changes bits against decode's
    per-row shape (``transformer.row_purity``); 0 = safe to fuse."""
    _check_family(cfg)
    return transformer.row_purity(params, cfg, batch, kq)


def spec_commit(cache: Params, new_pos, written, *, draft_k: int) -> Params:
    """Bulk-commit + rejected-suffix scrub after a verify forward, in
    place (``transformer.spec_commit``)."""
    return transformer.spec_commit(cache, new_pos, written, draft_k=draft_k)


def merge_prefill(cfg: ModelConfig, old: Params, new: Params,
                  active: torch.Tensor) -> Params:
    """Rows of ``new`` where ``active`` replace rows of ``old`` (in place;
    the encoder-decoder keeps ``old``'s cross-KV)."""
    if cfg.is_encdec:
        return encdec.merge_cache_encdec(old, new, active)
    return transformer.merge_cache(old, new, active)


def batch_spec(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, tuple]:
    """The shapes and dtypes of a training batch (the reference's
    ``batch_spec``, with ``(shape, dtype)`` pairs in place of
    ``jax.ShapeDtypeStruct``): int32 ``tokens`` and ``labels`` (B, S), and
    the frontends' bf16 ``embeds`` (B, F, d) or ``frames`` (B, T_enc,
    d)."""
    spec = {"tokens": ((batch, seq), torch.int32),
            "labels": ((batch, seq), torch.int32)}
    if cfg.frontend == "vit_stub":
        spec["embeds"] = ((batch, cfg.n_frontend_tokens, cfg.d_model),
                          torch.bfloat16)
    if cfg.is_encdec:
        spec["frames"] = ((batch, cfg.n_enc_tokens, cfg.d_model),
                          torch.bfloat16)
    return spec
