"""Dense decoder over the ring KV cache (counterpart of the reference's
``models/transformer.py``, its ring-serving subset).

Parameters keep the reference's layout: per block-pattern position one
dict whose leaves carry a leading ``(R, …)`` repeat axis, plus unrolled
``remainder`` blocks.  Where the reference scans over R, the port runs a
Python loop over the leading axis.

Decode uses the reference's ring-buffer cache: capacity C = window (local
attention) or max_len, with per-slot absolute positions (``cache["pos"]``
(B,), ``k_pos`` (B, C)) driving the mask, in bf16 or as dither-rounded int8
codes with per-position scales (``_kv_q8``).  Unlike the reference's pure
functions, ``decode_step`` and ``merge_cache`` update the cache tensors **in
place** (``index_put_`` / ``copy_``) and return a cache dict that shares
them, so a step costs no copy of the cache; callers that need the old cache
keep a clone.  Only attention layers (``kind="attn"``) of dense models are
ported; the rest of the zoo is ROADMAP Queue 1 item 11 and the paged layout
Queue 1 item 5.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.core import rounding
from repro_torch.kernels import dispatch
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.numerics.policy import dense

Params = Dict[str, Any]

__all__ = ["init_params", "init_cache", "prefill_with_cache", "merge_cache",
           "decode_step"]


def _kv_q8(t: torch.Tensor, ctr, idx, seed: int):
    """Dither-round K/V to int8 codes + per-position scales, bit for bit the
    reference's ``_kv_q8`` (DESIGN.md §6).

    The codes are a function of (value, absolute position + per-request
    offset, element index) only.  ``ctr`` and ``idx`` broadcast against
    ``t``; callers pass the absolute position (+ offset) as ``ctr`` and
    ``_kv_elem_idx`` as ``idx``.
    """
    tf = t.to(torch.float32)
    scale = torch.amax(torch.abs(tf), dim=-1) + 1e-6
    scaled = tf / scale[..., None] * 127.0 + 128.0
    slot_d = rounding.lcg_slot(ctr, idx, 16, seed=seed)
    u = rounding.hash_uniform(seed ^ 0xD1CE, idx, ctr)
    fl = torch.floor(scaled)
    codes = fl + rounding.dither_bit(scaled - fl, slot_d, u, 16)
    return (torch.clamp(codes, 0.0, 255.0) - 128.0).to(torch.int8), scale


def _kv_elem_idx(nkv: int, hd: int, device) -> torch.Tensor:
    """The (1, 1, nkv, hd) element-index pattern every KV-quantiser call
    hashes with: head·hd + lane, independent of the batch row (a single
    device, so the first head is 0)."""
    head = torch.arange(nkv, dtype=torch.int64, device=device)
    lane = torch.arange(hd, dtype=torch.int64, device=device)
    return (head[:, None] * hd + lane[None, :]).reshape(1, 1, nkv, hd)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _period(cfg: ModelConfig) -> int:
    return len(cfg.block_pattern) if cfg.block_pattern else 1


def _check_kind(kind: str) -> None:
    if kind != "attn":
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (SSM / RG-LRU blocks are "
            "ROADMAP Queue 1 item 11)")


def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
                device) -> Params:
    _check_kind(kind)
    if cfg.n_experts:
        raise NotImplementedError("MoE blocks are not ported yet (ROADMAP "
                                  "Queue 1 item 11)")
    d = cfg.d_model
    ones = torch.ones((d,), dtype=torch.bfloat16, device=device)
    return {"ln1": ones,
            "attn": layers.init_attention(gen, cfg, device=device),
            "ln2": ones.clone(),
            "mlp": layers.init_mlp(gen, d, cfg.d_ff, cfg.mlp_act,
                                   device=device)}


def _stack(trees: List[Params]) -> Params:
    """Stack a list of same-structured dicts leaf by leaf on a new axis 0."""
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def _index(tree: Params, r: int) -> Params:
    """Repeat ``r`` of a stacked dict: views, so writes reach the stack."""
    return {k: (_index(v, r) if isinstance(v, dict) else v[r])
            for k, v in tree.items()}


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device="cuda") -> Params:
    """Random bf16 weights drawn from ``gen`` (a generator on ``device``),
    in the reference's ``init_params`` layout.  The reference draws from
    ``jax.random``, so the values differ; ``interop.params_from_numpy``
    carries the reference's own weights over."""
    p_ = _period(cfg)
    rep, rem = divmod(cfg.n_layers, p_)
    vp = cfg.vocab_padded()
    params: Params = {"embed": layers.init_embedding(gen, vp, cfg.d_model,
                                                     device=device)}
    params["blocks"] = [
        _stack([_init_block(gen, cfg, cfg.layer_kind(pos), device)
                for _ in range(rep)])
        for pos in range(p_)] if rep else []
    params["remainder"] = [
        _init_block(gen, cfg, cfg.layer_kind(rep * p_ + i), device)
        for i in range(rem)]
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=torch.bfloat16,
                                      device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = layers._init(gen, (cfg.d_model, vp), scale=0.02,
                                         device=device)
    return params


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def _cache_entry(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 kv_quant: bool, device) -> Params:
    _check_kind(kind)
    cap = min(cfg.window, max_len) if cfg.window else max_len
    shape = (batch, cap, cfg.n_kv_heads, cfg.hd())
    entry = {
        "k": torch.zeros(shape, dtype=torch.int8 if kv_quant
                         else torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.int8 if kv_quant
                         else torch.bfloat16, device=device),
    }
    if kv_quant:
        for name in ("k_scale", "v_scale"):
            entry[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                      device=device)
    entry["k_pos"] = torch.full((batch, cap), -1, dtype=torch.int32,
                                device=device)
    return entry


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               kv_quant: bool = False, kv_layout: str = "ring",
               device="cuda") -> Params:
    """The ring decode cache: stacked ``(R, B, …)`` entries per pattern
    position, remainder entries, and per-slot positions ``pos`` (B,)."""
    if kv_layout == "paged":
        raise NotImplementedError("the paged KV layout is not ported yet "
                                  "(ROADMAP Queue 1 item 5)")
    if kv_layout != "ring":
        raise ValueError(f"unknown kv_layout {kv_layout!r}")
    p_ = _period(cfg)
    rep, rem = divmod(cfg.n_layers, p_)
    stacked = []
    if rep:
        for pos in range(p_):
            one = _cache_entry(cfg, cfg.layer_kind(pos), batch, max_len,
                               kv_quant, device)
            stacked.append({k: v.expand((rep,) + v.shape).contiguous()
                            for k, v in one.items()})
    remainder = [_cache_entry(cfg, cfg.layer_kind(rep * p_ + i), batch,
                              max_len, kv_quant, device) for i in range(rem)]
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "layers": stacked, "remainder": remainder}


# ---------------------------------------------------------------------------
# decode attention over the ring cache
# ---------------------------------------------------------------------------


def _attention_decode(params: Params, cfg: ModelConfig, x: torch.Tensor,
                      cache: Params, pos: torch.Tensor, policy, counter,
                      kv_offset=None, backend: Optional[str] = None):
    """One-token attention against one layer's ring cache entry.
    x: (B, 1, d); ``pos`` (B,) int32 per-slot absolute positions.

    Writes the new token's K/V (int8 codes + scales when the cache is
    quantised, with counter = position + ``kv_offset``) into ring slot
    ``pos % cap`` **in place**, then runs flash-decode attention through
    the kernel dispatcher (``backend`` None: the CUDA kernel on the card,
    the plain version on the CPU).
    """
    b = x.shape[0]
    hd, nh, nkv = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
    q = dense(x, params["wq"], policy, counter, seed=1).reshape(b, 1, nh, hd)
    k = dense(x, params["wk"], policy, counter, seed=2).reshape(b, 1, nkv, hd)
    v = dense(x, params["wv"], policy, counter, seed=3).reshape(b, 1, nkv, hd)
    if cfg.qkv_bias and "bq" in params:
        q = q + params["bq"].reshape(1, 1, nh, hd)
        k = k + params["bk"].reshape(1, 1, nkv, hd)
        v = v + params["bv"].reshape(1, 1, nkv, hd)
    posv = pos[:, None]
    q = layers.rope(q, posv, cfg.rope_theta)
    k = layers.rope(k, posv, cfg.rope_theta)

    cap = cache["k"].shape[1]
    rows = torch.arange(b, device=x.device)
    slot = torch.remainder(pos, cap)
    if cache["k"].dtype == torch.int8:
        ctr = pos if kv_offset is None else pos + kv_offset
        ctr4 = ctr.reshape(b, 1, 1, 1)
        idx4 = _kv_elem_idx(nkv, hd, x.device)
        kq, ks = _kv_q8(k, ctr4, idx4, 101)
        vq, vs = _kv_q8(v, ctr4, idx4, 102)
        cache["k"][rows, slot] = kq[:, 0]
        cache["v"][rows, slot] = vq[:, 0]
        cache["k_scale"][rows, slot] = ks[:, 0]
        cache["v_scale"][rows, slot] = vs[:, 0]
    else:
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    cache["k_pos"][rows, slot] = pos

    group = nh // nkv
    qg = q[:, 0].reshape(b, nkv, group, hd)
    attn = dispatch.decode_attention(
        qg, cache["k"], cache["v"], cache["k_pos"], pos,
        k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
        window=cfg.window or 0, backend=backend)
    out = attn.to(x.dtype).reshape(b, 1, nh * hd)
    return dense(out, params["wo"], policy, counter, seed=4), cache


# ---------------------------------------------------------------------------
# block application (prefill / decode)
# ---------------------------------------------------------------------------


def _apply_block(bp: Params, cfg: ModelConfig, kind: str, x: torch.Tensor,
                 positions, *, policy, counter, cache_entry=None, pos=None,
                 kv_offset=None, collect_kv: bool = False,
                 backend: Optional[str] = None):
    _check_kind(kind)
    h = layers.rms_norm(x, bp["ln1"], cfg.norm_eps)
    new_cache = cache_entry
    if cache_entry is not None:
        out, new_cache = _attention_decode(bp["attn"], cfg, h, cache_entry,
                                           pos, policy, counter,
                                           kv_offset=kv_offset,
                                           backend=backend)
    else:
        out, kv = layers.attention(bp["attn"], cfg, h, positions,
                                   window=cfg.window, policy=policy,
                                   counter=counter, return_kv=collect_kv)
        if collect_kv:
            new_cache = kv
    x = x + out
    h2 = layers.rms_norm(x, bp["ln2"], cfg.norm_eps)
    x = x + layers.mlp(bp["mlp"], h2, cfg.mlp_act, policy, counter)
    return x, new_cache


def _layers(params: Params, cfg: ModelConfig):
    """(block params, kind, stacked position, repeat or None) in layer
    order: the reference's scan over stacked repeats, then the remainder."""
    p_ = _period(cfg)
    rep = cfg.n_layers // p_
    if params["blocks"]:
        for r in range(rep):
            for pos_i in range(p_):
                yield (_index(params["blocks"][pos_i], r),
                       cfg.layer_kind(pos_i), pos_i, r)
    for i, bp in enumerate(params["remainder"]):
        yield bp, cfg.layer_kind(rep * p_ + i), i, None


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor):
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return dense(x, head, None, 0, seed=9).to(torch.float32)


# ---------------------------------------------------------------------------
# batched prefill into the ring cache
# ---------------------------------------------------------------------------


def _prefill_entry(cfg: ModelConfig, kv, lengths: torch.Tensor, cap: int,
                   kv_quant: bool, kv_offset) -> Params:
    """Scatter one attention layer's full-sequence K/V into a ring entry.

    Ring slot j holds the last prompt position p ≡ j (mod cap) below the
    slot's prompt length — the layout token-by-token decode writes would
    have left, int8 codes included (counter = absolute position + offset).
    """
    k_full, v_full = kv
    b, s = k_full.shape[0], k_full.shape[1]
    dev = k_full.device
    j = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    last = lengths[:, None].to(torch.int32) - 1                 # (B, 1)
    pj = last - torch.remainder(last - j, cap)                  # (B, cap)
    valid = pj >= 0
    idx = torch.clamp(pj, 0, s - 1).long()
    rows = torch.arange(b, device=dev)[:, None]
    gk, gv = k_full[rows, idx], v_full[rows, idx]               # (B, cap, …)
    k_pos = torch.where(valid, pj, -1).to(torch.int32)
    v4 = valid[:, :, None, None]
    if not kv_quant:
        return {"k": torch.where(v4, gk.to(torch.bfloat16), 0.0),
                "v": torch.where(v4, gv.to(torch.bfloat16), 0.0),
                "k_pos": k_pos}

    off = (torch.zeros((b,), dtype=torch.int32, device=dev)
           if kv_offset is None
           else torch.broadcast_to(kv_offset.to(torch.int32), (b,)))
    ctr = (pj + off[:, None])[:, :, None, None]                 # (B, cap, 1, 1)
    idx4 = _kv_elem_idx(k_full.shape[2], k_full.shape[3], dev)
    kq, ks = _kv_q8(gk, ctr, idx4, 101)
    vq, vs = _kv_q8(gv, ctr, idx4, 102)
    zero8 = torch.zeros((), dtype=torch.int8, device=dev)
    return {"k": torch.where(v4, kq, zero8), "v": torch.where(v4, vq, zero8),
            "k_scale": torch.where(valid[:, :, None], ks, 0.0),
            "v_scale": torch.where(valid[:, :, None], vs, 0.0),
            "k_pos": k_pos}


def prefill_with_cache(params: Params, cfg: ModelConfig,
                       tokens: torch.Tensor, lengths: torch.Tensor,
                       max_len: int, *, policy=None, counter=0,
                       kv_quant: bool = False, kv_offset=None):
    """Batched prefill: one full-sequence forward over right-padded prompts
    (B, S) with true lengths (B,) that also builds the ring decode cache.
    Returns ``(logits (B, S, vocab_size) f32, cache)`` with
    ``cache["pos"] == lengths``."""
    x = params["embed"][tokens]
    b, s, _ = x.shape
    lengths = lengths.to(torch.int32)
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    kvs: Dict[Any, List] = {}
    for bp, kind, pos_i, r in _layers(params, cfg):
        x, kv = _apply_block(bp, cfg, kind, x, positions, policy=policy,
                             counter=counter, collect_kv=True)
        kvs.setdefault((r is None, pos_i), []).append(kv)
    logits = _logits(params, cfg, x)[:, :, : cfg.vocab_size]

    cap = min(cfg.window, max_len) if cfg.window else max_len

    def entry(kv):
        return _prefill_entry(cfg, kv, lengths, cap, kv_quant, kv_offset)

    stacked = [_stack([entry(kv) for kv in kvs[(False, pos_i)]])
               for pos_i in range(len(params["blocks"]))]
    remainder = [entry(kvs[(True, i)][0])
                 for i in range(len(params["remainder"]))]
    return logits, {"pos": lengths, "layers": stacked, "remainder": remainder}


def merge_cache(old: Params, new: Params, active: torch.Tensor) -> Params:
    """Per-slot cache insertion: rows of ``new`` where ``active`` (B,) bool
    replace rows of ``old``, **in place** in ``old``'s tensors (stacked
    entries carry batch at axis 1, remainder entries at axis 0)."""
    def sel(o_tree, n_tree, axis):
        for key, o in o_tree.items():
            shp = [1] * o.dim()
            shp[axis] = active.shape[0]
            o.copy_(torch.where(active.reshape(shp), n_tree[key], o))

    for o, n in zip(old["layers"], new["layers"]):
        sel(o, n, 1)
    for o, n in zip(old["remainder"], new["remainder"]):
        sel(o, n, 0)
    return {"pos": torch.where(active, new["pos"], old["pos"]),
            "layers": old["layers"], "remainder": old["remainder"]}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, *, policy=None, counter=0, kv_offset=None,
                backend: Optional[str] = None):
    """One decode step: (B,) tokens + ring cache → ((B, vocab_size) f32
    logits, cache).  Every slot advances by one; the cache's layer tensors
    are updated in place and shared by the returned cache.  ``kv_offset``
    (B,) shifts the int8-KV dither counter per slot.  ``backend`` selects
    the decode-attention kernel backend (None: by device)."""
    x = params["embed"][token[:, None]]
    b = x.shape[0]
    pos = torch.broadcast_to(cache["pos"].to(torch.int32), (b,)).contiguous()
    positions = pos[:, None]
    for bp, kind, pos_i, r in _layers(params, cfg):
        entry = (_index(cache["layers"][pos_i], r) if r is not None
                 else cache["remainder"][pos_i])
        x, _ = _apply_block(bp, cfg, kind, x, positions, policy=policy,
                            counter=counter, cache_entry=entry, pos=pos,
                            kv_offset=kv_offset, backend=backend)
    logits = _logits(params, cfg, x)[:, 0, : cfg.vocab_size]
    return logits, {"pos": pos + 1, "layers": cache["layers"],
                    "remainder": cache["remainder"]}
