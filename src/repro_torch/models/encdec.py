"""Whisper-style encoder-decoder (arXiv:2212.04356) of the port: the
reference's ``models/encdec.py`` in torch.

The conv audio frontend is a stub: ``frames`` are precomputed frame
embeddings (B, n_enc_tokens, d_model).  The encoder is bidirectional
without RoPE; the decoder is causal self-attention with RoPE, then
cross-attention over the encoder output, then the GELU MLP, each behind a
pre-LayerNorm (``cfg.norm_eps``).  The head is the tied embedding, a
plain product (no policy), as in the reference.

Params keep the reference's tree: ``enc_blocks`` and ``dec_blocks``
stacked on a leading layer axis, ``enc_pos``, ``enc_norm``, ``embed``
and ``final_norm`` (each norm ``{"g", "b"}``).

The decode cache keeps the decoder-only cache's layout so the engine's
per-layer sites (prefill reset, merge, restore, graph capture) treat its
self-KV as any ring: ``{"pos" (B,), "layers": [the self-KV ring, stacked
(L, B, C, n_kv, hd) bf16 with ``k_pos`` (L, B, C)], "remainder": [],
"cross": {"k", "v"}}``, the cross-KV (L, B, n_enc_tokens, n_kv, hd) bf16
of each slot's own frames, outside ``layers``: it is static per slot row,
so nothing that resets, merges or rewrites the self-KV touches it.  The
reference's cache is ``{"pos", "self", "cross_k", "cross_v"}``
(``interop.cache_from_numpy`` maps it).  The self-KV is bf16 whatever
``kv_quant`` says, as the reference's.  ``decode_step_encdec`` updates the
self-KV in place, as the port's ``transformer.decode_step`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.dist import ctx as dist_ctx
from repro_torch.models import layers, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.numerics.policy import dense, matmul

Params = Dict[str, Any]

__all__ = ["init_encdec", "encode", "forward_encdec", "decode_step_encdec",
           "init_encdec_cache", "merge_cache_encdec"]


def _ln(d: int, device) -> Params:
    return {"g": torch.ones((d,), dtype=torch.bfloat16, device=device),
            "b": torch.zeros((d,), dtype=torch.bfloat16, device=device)}


def _init_enc_layer(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    return {"ln1": _ln(cfg.d_model, device),
            "attn": layers.init_attention(gen, cfg, device=device),
            "ln2": _ln(cfg.d_model, device),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, "gelu",
                                   device=device)}


def _init_dec_layer(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    return {"ln1": _ln(cfg.d_model, device),
            "attn": layers.init_attention(gen, cfg, device=device),
            "ln_x": _ln(cfg.d_model, device),
            "xattn": layers.init_attention(gen, cfg, device=device),
            "ln2": _ln(cfg.d_model, device),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, "gelu",
                                   device=device)}


def init_encdec(gen: torch.Generator, cfg: ModelConfig,
                device="cuda") -> Params:
    """Random bf16 weights drawn from ``gen`` in the reference's tree (its
    values differ: the reference draws from ``jax.random``)."""
    ne, nd = cfg.n_enc_layers, cfg.n_layers
    return {
        "enc_blocks": transformer._stack(
            (_init_enc_layer(gen, cfg, device) for _ in range(ne)), ne),
        "enc_pos": layers._init(gen, (cfg.n_enc_tokens, cfg.d_model),
                                scale=0.02, device=device),
        "enc_norm": _ln(cfg.d_model, device),
        "dec_blocks": transformer._stack(
            (_init_dec_layer(gen, cfg, device) for _ in range(nd)), nd),
        "embed": layers.init_embedding(gen, cfg.vocab_padded(), cfg.d_model,
                                       device=device),
        "final_norm": _ln(cfg.d_model, device),
    }


def _lnorm(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    return layers.layer_norm(x, p["g"], p["b"], cfg.norm_eps)


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor, *,
           policy=None, counter=0) -> torch.Tensor:
    """frames (B, n_enc_tokens, d_model) stub embeddings → the encoder's
    output (B, n_enc_tokens, d_model) bf16: ``frames + enc_pos``, then
    bidirectional pre-LN blocks without RoPE, then ``enc_norm``."""
    b, s, _ = frames.shape
    x = frames.to(torch.bfloat16) + params["enc_pos"][None, :s]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    for i in range(cfg.n_enc_layers):
        bp = transformer._index(params["enc_blocks"], i)
        a, _ = layers.attention(bp["attn"], cfg, _lnorm(x, bp["ln1"], cfg),
                                positions, causal=False, policy=policy,
                                counter=counter, use_rope=False)
        x = x + a
        x = x + layers.mlp(bp["mlp"], _lnorm(x, bp["ln2"], cfg), "gelu",
                           policy, counter, d_ff=cfg.d_ff)
    return _lnorm(x, params["enc_norm"], cfg)


def forward_encdec(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   frames: torch.Tensor, *, policy=None, counter=0,
                   remat: bool = True) -> torch.Tensor:
    """Training / prefill forward → f32 logits (B, S, vocab_padded).  The
    cross-attention projects the encoder output through ``dense`` (under
    a policy, quantised).  ``remat`` recomputes each decoder layer in the
    backward pass (non-reentrant ``torch.utils.checkpoint``), as the
    reference's ``jax.checkpoint`` of its scanned decoder body; the
    encoder is not recomputed, as there.

    On the training mesh (``dist.ctx.train_shard``, DESIGN.md §5) params
    are this rank's blocks and tokens and frames its data shard's rows:
    every attention (the encoder's, the decoder's and the cross one) runs
    on the rank's heads (``layers.attention``), the MLPs column/row
    parallel, ``enc_pos`` and the LayerNorms replicated, and the tied
    head by vocab: the logits come out (B / dp, S, vocab_padded / tp)
    for the trainer's sharded loss."""
    enc = encode(params, cfg, frames, policy=policy, counter=counter)
    b, s = tokens.shape
    x = layers.embed_lookup(params["embed"], tokens, cfg.vocab_padded())
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)

    def body(bp, h):
        a, _ = layers.attention(bp["attn"], cfg, _lnorm(h, bp["ln1"], cfg),
                                positions, causal=True, policy=policy,
                                counter=counter)
        h = h + a
        c, _ = layers.attention(bp["xattn"], cfg,
                                _lnorm(h, bp["ln_x"], cfg), positions,
                                causal=False, kv_src=enc, policy=policy,
                                counter=counter, use_rope=False)
        h = h + c
        return h + layers.mlp(bp["mlp"], _lnorm(h, bp["ln2"], cfg), "gelu",
                              policy, counter, d_ff=cfg.d_ff)

    for i in range(cfg.n_layers):
        bp = transformer._index(params["dec_blocks"], i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(body, bp, x,
                                                  use_reentrant=False)
        else:
            x = body(bp, x)
    x = _lnorm(x, params["final_norm"], cfg)
    if params["embed"].shape[0] != cfg.vocab_padded():
        x = dist_ctx.copy_to_model(x)      # the vocab-parallel tied head
    return matmul(x, params["embed"].T).to(torch.float32)


def _stacked_xkv(params: Params, enc: torch.Tensor, cfg: ModelConfig,
                 batch: int) -> Params:
    """The cross K/V of every decoder layer, (L, B, T, n_kv, hd) bf16:
    plain products of the encoder output (no policy), as the
    reference's."""
    hd, nkv = cfg.hd(), cfg.n_kv_heads
    blocks = params["dec_blocks"]["xattn"]
    return {name: torch.stack([
        matmul(enc, blocks[w][i]).reshape(batch, -1, nkv, hd)
        .to(torch.bfloat16) for i in range(cfg.n_layers)])
        for name, w in (("k", "wk"), ("v", "wv"))}


def init_encdec_cache(params: Params, cfg: ModelConfig,
                      frames: Optional[torch.Tensor], batch: int,
                      max_len: int, *, policy=None, cross=None,
                      device=None) -> Params:
    """The decode cache: an empty bf16 self-KV ring of ``max_len`` slots
    per decoder layer and the cross-KV of ``frames`` (B, n_enc_tokens, d)
    — the encoder under ``policy`` at counter 0, as the reference's —
    row i slot i's.  ``cross`` (a cache's ``"cross"``) is shared instead
    of encoding ``frames`` again."""
    if cross is None:
        if frames is None:
            raise ValueError(f"{cfg.name!r} is an encoder-decoder: its cache "
                             "needs frames")
        if frames.shape[0] != batch:
            raise ValueError(f"frames hold {frames.shape[0]} rows; the cache "
                             f"has {batch} slots")
        enc = encode(params, cfg, frames, policy=policy)
        cross = _stacked_xkv(params, enc, cfg, batch)
    device = cross["k"].device if device is None else torch.device(device)
    hd, nkv, nl = cfg.hd(), cfg.n_kv_heads, cfg.n_layers
    shape = (nl, batch, max_len, nkv, hd)
    self_kv = {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
               "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
               "k_pos": torch.full((nl, batch, max_len), -1,
                                   dtype=torch.int32, device=device)}
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "layers": [self_kv], "remainder": [], "cross": cross}


def merge_cache_encdec(old: Params, new: Params,
                       active: torch.Tensor) -> Params:
    """Per-slot cache insertion (``transformer.merge_cache``, in place):
    the self-KV rows of ``new`` where ``active`` (B,) replace ``old``'s;
    the static cross-KV is kept from ``old``."""
    merged = transformer.merge_cache(old, new, active)
    merged["cross"] = old["cross"]
    return merged


def _cross_decode(params: Params, cfg: ModelConfig, h: torch.Tensor,
                  xk: torch.Tensor, xv: torch.Tensor, policy,
                  counter) -> torch.Tensor:
    """One query row per slot against the static cross K/V (B, T, n_kv,
    hd), in the reference's order: the score product out in bf16, cast to
    f32 and divided by sqrt(hd), softmax, the probs cast to bf16 before
    the value product.  q and o are ``dense`` (seeds 1 and 4).

    On the training mesh with the heads split (``train_param_specs``),
    ``wq`` is column-parallel and ``wo`` row-parallel (partials summed
    over 'model'), and ``xk`` / ``xv`` hold the rank's heads, as
    ``cache_specs`` cuts them; where the KV heads do not divide, the
    cross-KV is whole and the rank reads its query heads' KV heads."""
    b = h.shape[0]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    sh = layers.tp_shard()
    split = sh is not None and params["wq"].shape[-1] != nh * hd
    col = layers.col_shard(h, params["wq"], sh) if split else None
    nh_l = params["wq"].shape[-1] // hd
    if split and xk.shape[2] == nkv:
        kv0, nkv_l, _ = layers._kv_heads(cfg, sh.tp, sh.model)
        xk, xv = xk[:, :, kv0:kv0 + nkv_l], xv[:, :, kv0:kv0 + nkv_l]
    nkv_l = xk.shape[2]
    q = dense(h, params["wq"], policy, counter, seed=1, shard=col).reshape(
        b, 1, nkv_l, nh_l // nkv_l, hd)
    logits = layers.grouped_logits(q, xk)
    probs = layers.softmax(logits, dim=-1).to(h.dtype)
    c = layers.grouped_values(probs, xv).reshape(b, 1, nh_l * hd)
    row = layers.row_shard(c, params["wo"], sh) if split else None
    return dense(c, params["wo"], policy, counter, seed=4, shard=row)


def decode_step_encdec(params: Params, cfg: ModelConfig,
                       token: torch.Tensor, cache: Params, *, policy=None,
                       counter=0, kv_offset=None,
                       backend: Optional[str] = None,
                       active: Optional[torch.Tensor] = None,
                       attn_block: Optional[tuple] = None):
    """One decoder token for every slot: ring self-attention (the decode
    attention kernel on the card, ``backend`` None, at tile
    ``attn_block``) and cross-attention
    against the static cross-KV → ((B, vocab_size) f32 logits, cache).
    ``cache["pos"]`` is per slot (B,); the self-KV is written in place
    (rows where ``active`` is False write their slot's old contents
    back).  ``kv_offset`` is accepted for the API's sake: the self-KV is
    bf16.

    On the training mesh (``dist.ctx.train_shard_scope``) params and cache
    are this rank's blocks (``interop.shard_train_params``,
    ``interop.shard_cache``) and ``token`` its data shard's rows: the
    self- and cross-attention run on the rank's heads where the head
    count divides ``tp`` (else replicated, as the layout keeps them), the
    MLP column/row-parallel, the tied head vocab-parallel with the logits
    gathered over 'model'."""
    del kv_offset
    x = layers.embed_lookup(params["embed"], token[:, None],
                            cfg.vocab_padded())
    b = x.shape[0]
    pos = torch.broadcast_to(cache["pos"].to(torch.int32), (b,)).contiguous()
    cross = cache["cross"]
    for i in range(cfg.n_layers):
        bp = transformer._index(params["dec_blocks"], i)
        entry = transformer._index(cache["layers"][0], i)
        a, _ = transformer._attention_decode(
            bp["attn"], cfg, _lnorm(x, bp["ln1"], cfg), entry, pos, policy,
            counter, backend=backend, active=active, attn_block=attn_block)
        x = x + a
        x = x + _cross_decode(bp["xattn"], cfg, _lnorm(x, bp["ln_x"], cfg),
                              cross["k"][i], cross["v"][i], policy, counter)
        x = x + layers.mlp(bp["mlp"], _lnorm(x, bp["ln2"], cfg), "gelu",
                           policy, counter, d_ff=cfg.d_ff)
    x = _lnorm(x, params["final_norm"], cfg)
    logits = matmul(x, params["embed"].T).to(torch.float32)
    return transformer._gather_vocab(logits, cfg), {
        "pos": pos + 1, "layers": cache["layers"],
        "remainder": cache["remainder"], "cross": cross}
