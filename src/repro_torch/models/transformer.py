"""Dense decoder: the full-sequence forward of training and the serving
path over the ring or the paged KV cache (counterpart of the reference's
``models/transformer.py``).

Parameters keep the reference's layout: per block-pattern position one
dict whose leaves carry a leading ``(R, …)`` repeat axis, plus unrolled
``remainder`` blocks.  Where the reference scans over R, the port runs a
Python loop over the leading axis.

Decode uses the reference's ring-buffer cache: capacity C = window (local
attention) or max_len, with per-slot absolute positions (``cache["pos"]``
(B,), ``k_pos`` (B, C)) driving the mask, in bf16 or as dither-rounded int8
codes with per-position scales (``_kv_q8``).  The paged layout
(DESIGN.md §6) keeps per layer a pool of fixed-size token blocks plus a
trailing trash block, shared by every slot through one ``block_tables``
(B, nbmax) map; ``prefill_with_cache_paged`` writes prompt suffixes into
it and joins prefix blocks other requests already wrote;
``prefill_with_cache_chunked`` does the same on the ring, one prompt chunk
at a time, joining each slot's ring history (DESIGN.md §11).  Speculative
decoding scores K draft positions per slot in one ``verify_step`` and
commits the accepted prefix with ``spec_commit`` (DESIGN.md §14).  Unlike
the reference's pure functions, ``decode_step``, ``verify_step``,
``spec_commit``, ``merge_cache``, ``prefill_with_cache_paged`` and
``prefill_with_cache_chunked`` update the cache tensors **in place**
(``index_put_`` / ``copy_``) and return a cache dict that shares them, so
a step costs no copy of the cache; callers that need the old cache keep a
clone.  Blocks are attention layers (``kind="attn"``), RG-LRU
recurrences (``"rglru"``, ``models/hybrid.py``) or SSD layers (``"ssm"``,
``models/ssm.py``, norm → SSD only); the first two are followed by the
SwiGLU or GELU MLP or, where the config has experts, the MoE FFN
(``models/moe.py``).  A recurrent layer's cache entry is its state
(``h``, ``conv``), which ``decode_step`` updates in place like the KV;
given ``active`` (B,), rows that are not active keep their state and
write no KV, which the scanned prefill and the inert rows of a decode
window rely on.  ``forward`` prepends a VLM's stub-frontend ``embeds``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.core import rounding
from repro_torch.dist import ctx as dist_ctx
from repro_torch.kernels import dispatch
from repro_torch.models import hybrid, layers, moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.numerics.policy import dense

Params = Dict[str, Any]

__all__ = ["init_params", "init_cache", "forward", "prefill",
           "prefill_with_cache",
           "prefill_with_cache_chunked", "prefill_with_cache_paged",
           "merge_cache", "decode_step", "verify_step", "spec_commit",
           "row_purity", "shard_purity", "VERIFY_OPS"]


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


def _kv_elem_idx(nkv: int, hd: int, device,
                 head0: Optional[int] = None) -> torch.Tensor:
    """The (1, 1, nkv, hd) element-index pattern every KV-quantiser call
    hashes with: global head·hd + lane, independent of the batch row (a
    shared block must not remember which slot wrote it, and sharded
    serving moves slots between data shards).  Under head sharding the
    model sees local heads; the shard's global head offset is ``head0``
    (the training layout's decode passes it) or comes from
    ``dist.ctx.serve_shard_scope``, as the reference's does."""
    info = dist_ctx.kv_shard_info()
    if head0 is None:
        head0 = info["head0"] if info is not None and info["heads_sharded"] \
            else 0
    head = head0 + torch.arange(nkv, dtype=torch.int64, device=device)
    lane = torch.arange(hd, dtype=torch.int64, device=device)
    return (head[:, None] * hd + lane[None, :]).reshape(1, 1, nkv, hd)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _period(cfg: ModelConfig) -> int:
    return len(cfg.block_pattern) if cfg.block_pattern else 1


KINDS = ("attn", "rglru", "ssm")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown layer kind {kind!r}; expected one of "
                         f"{KINDS}")


def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
                device) -> Params:
    """One block in the reference's key layout: ``"attn"``, ``"rec"`` or
    ``"ssm"`` after ``ln1``; then, except for SSD blocks (norm → SSD
    only), ``ln2`` and the MLP, or ``"moe"`` where the config has
    experts."""
    _check_kind(kind)
    d = cfg.d_model
    ones = torch.ones((d,), dtype=torch.bfloat16, device=device)
    p = {"ln1": ones}
    if kind == "attn":
        p["attn"] = layers.init_attention(gen, cfg, device=device)
    elif kind == "rglru":
        p["rec"] = hybrid.init_rglru(gen, cfg, device=device)
    else:
        p["ssm"] = ssm.init_ssm(gen, cfg, device=device)
        return p
    p["ln2"] = ones.clone()
    if cfg.n_experts:
        p["moe"] = moe.init_moe(gen, cfg, device=device)
    else:
        p["mlp"] = layers.init_mlp(gen, d, cfg.d_ff, cfg.mlp_act,
                                   device=device)
    return p


def _stack(trees: Iterable[Params], n: int) -> Params:
    """Stack ``n`` same-structured dicts leaf by leaf on a new axis 0.  Each
    tree is copied into its row as it arrives, so a generator of trees
    (``init_params``) never holds more than one beside the stack: a
    stacked model's weights fit the card once, not twice."""
    out: Params = {}
    for r, tree in enumerate(trees):
        _put_row(out, tree, r, n)
    return out


def _put_row(out: Params, tree: Params, r: int, n: int) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _put_row(out.setdefault(k, {}), v, r, n)
            continue
        if k not in out:
            out[k] = torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                                 device=v.device)
        out[k][r].copy_(v)


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
        _stack((_init_block(gen, cfg, cfg.layer_kind(pos), device)
                for _ in range(rep)), rep)
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
    """One layer's decode cache: the ring (capacity ``min(window,
    max_len)`` for local attention) or a recurrent layer's zero state."""
    _check_kind(kind)
    if kind == "rglru":
        return hybrid.init_rglru_state(cfg, batch, device=device)
    if kind == "ssm":
        return ssm.init_ssm_state(cfg, batch, device=device)
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


def _paged_cache_entry(cfg: ModelConfig, kind: str, num_blocks: int,
                       block_size: int, kv_quant: bool, device,
                       data_shards: int = 1) -> Params:
    """One attention layer's share of the paged block pool: ``num_blocks``
    usable blocks of ``block_size`` token slots plus a trailing *trash*
    block (physical id ``num_blocks``) that absorbs writes through
    unallocated block-table entries; what is read from it is masked or
    (idle rows) discarded.  The reference's sharded layout (DESIGN.md §9)
    holds ``data_shards`` such shard-local pools back to back, each with
    its own trash block, so block-table entries stay shard-local ids; one
    rank of the port's sharded engine holds its own shard's pool (1)."""
    if kind != "attn":
        raise ValueError("paged KV layout requires attention-only layers")
    shape = (data_shards * (num_blocks + 1), block_size, cfg.n_kv_heads,
             cfg.hd())
    dtype = torch.int8 if kv_quant else torch.bfloat16
    entry = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kv_quant:
        for name in ("k_scale", "v_scale"):
            entry[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                      device=device)
    return entry


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               kv_quant: bool = False, kv_layout: str = "ring",
               block_size: Optional[int] = None,
               num_blocks: Optional[int] = None, device="cuda",
               data_shards: int = 1) -> Params:
    """The decode cache: stacked ``(R, …)`` entries per pattern position,
    remainder entries, and per-slot positions ``pos`` (B,).  The paged
    layout holds ``num_blocks`` usable blocks of ``block_size`` tokens per
    data shard (default ``batch / data_shards × ceil(max_len /
    block_size)``, the dense ring's token count) plus a trash block each,
    and ``block_tables`` (B, nbmax) whose unset entries are the shard-local
    trash id ``num_blocks``."""
    if kv_layout not in ("ring", "paged"):
        raise ValueError(f"unknown kv_layout {kv_layout!r}")
    if data_shards < 1 or batch % data_shards:
        raise ValueError(f"batch {batch} must divide into {data_shards} "
                         "data shards")
    paged = kv_layout == "paged"
    if paged:
        if not block_size or block_size <= 0:
            raise ValueError("paged kv_layout requires a positive block_size")
        nbmax = -(-max_len // block_size)           # blocks per full request
        num_blocks = (num_blocks if num_blocks is not None
                      else (batch // data_shards) * nbmax)

    def entry(kind):
        if paged:
            return _paged_cache_entry(cfg, kind, num_blocks, block_size,
                                      kv_quant, device, data_shards)
        return _cache_entry(cfg, kind, batch, max_len, kv_quant, device)

    p_ = _period(cfg)
    rep, rem = divmod(cfg.n_layers, p_)
    stacked = []
    if rep:
        for pos in range(p_):
            one = entry(cfg.layer_kind(pos))
            stacked.append({k: v.expand((rep,) + v.shape).contiguous()
                            for k, v in one.items()})
    remainder = [entry(cfg.layer_kind(rep * p_ + i)) for i in range(rem)]
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
             "layers": stacked, "remainder": remainder}
    if paged:
        cache["block_tables"] = torch.full((batch, nbmax), num_blocks,
                                           dtype=torch.int32, device=device)
    return cache


# ---------------------------------------------------------------------------
# decode attention over the ring or paged cache
# ---------------------------------------------------------------------------


def _attention_decode(params: Params, cfg: ModelConfig, x: torch.Tensor,
                      cache: Params, pos: torch.Tensor, policy, counter,
                      kv_offset=None, backend: Optional[str] = None,
                      block_tables: Optional[torch.Tensor] = None,
                      active: Optional[torch.Tensor] = None,
                      attn_block: Optional[tuple] = None):
    """One-token attention against one layer's cache entry.
    x: (B, 1, d); ``pos`` (B,) int32 per-slot absolute positions.

    Writes the new token's K/V (int8 codes + scales when the cache is
    quantised, with counter = position + ``kv_offset``) **in place**: into
    ring slot ``pos % cap``, or — when ``block_tables`` (B, nbmax) selects
    the paged layout — into pool block ``block_tables[b, pos // bs]`` at
    in-block slot ``pos % bs`` (the engine has made that block exist and
    uniquely owned, or pointed the row at the trash block).  Rows where
    ``active`` (B,) is False write their slot's old contents back.  Then
    runs flash-decode attention through the kernel dispatcher
    (``backend`` None: the CUDA kernel on the card, the plain version on
    the CPU) at ``attn_block``, the ring tile (None: the dispatcher's
    default; a paged cache's tile is its pool block).

    On the training mesh (``layers.tp_shard``) with the query heads split
    (``train_param_specs``), q takes the rank's heads (``wq``
    column-parallel), and so do K and V where the KV heads divide
    ``tp``: the cache entry is then the rank's block of heads
    (``cache_specs``) and int8 codes hash at the global head index.
    Otherwise K and V are computed whole into the replicated cache, and
    the kernel reads the KV heads of the rank's query heads.  ``wo`` is
    row-parallel, its partials summed over 'model' in ``dense``.
    """
    b = x.shape[0]
    hd, nh, nkv = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
    sh = layers.tp_shard()
    q_split = sh is not None and params["wq"].shape[-1] != nh * hd
    kv_split = q_split and params["wk"].shape[-1] != nkv * hd
    col = layers.col_shard(x, params["wq"], sh) if q_split else None
    kv_col = layers.col_shard(x, params["wk"], sh) if kv_split else None
    nh_l = params["wq"].shape[-1] // hd
    nkv_c = params["wk"].shape[-1] // hd          # the KV heads computed
    q = dense(x, params["wq"], policy, counter, seed=1,
              shard=col).reshape(b, 1, nh_l, hd)
    k = dense(x, params["wk"], policy, counter, seed=2,
              shard=kv_col).reshape(b, 1, nkv_c, hd)
    v = dense(x, params["wv"], policy, counter, seed=3,
              shard=kv_col).reshape(b, 1, nkv_c, hd)
    if cfg.qkv_bias and "bq" in params:
        q = q + params["bq"].reshape(1, 1, nh_l, hd)
        k = k + params["bk"].reshape(1, 1, nkv_c, hd)
        v = v + params["bv"].reshape(1, 1, nkv_c, hd)
    posv = pos[:, None]
    q = layers.rope(q, posv, cfg.rope_theta)
    k = layers.rope(k, posv, cfg.rope_theta)

    paged = block_tables is not None
    width = cache["k"].shape[1]                     # ring cap or block size
    slot = torch.remainder(pos, width)
    if paged:
        logical = torch.clamp(torch.div(pos, width, rounding_mode="floor"),
                              0, block_tables.shape[1] - 1)
        rows = block_tables.gather(1, logical[:, None].long())[:, 0].long()
    else:
        rows = torch.arange(b, device=x.device)
    def put(name, new):
        if active is not None:
            keep = active.reshape((b,) + (1,) * (new.dim() - 1))
            new = torch.where(keep, new, cache[name][rows, slot])
        cache[name][rows, slot] = new

    if cache["k"].dtype == torch.int8:
        ctr = pos if kv_offset is None else pos + kv_offset
        ctr4 = ctr.reshape(b, 1, 1, 1)
        idx4 = _kv_elem_idx(nkv_c, hd, x.device,
                            sh.model * nkv_c if kv_split else None)
        kq, ks = _kv_q8(k, ctr4, idx4, 101)
        vq, vs = _kv_q8(v, ctr4, idx4, 102)
        put("k", kq[:, 0])
        put("v", vq[:, 0])
        put("k_scale", ks[:, 0])
        put("v_scale", vs[:, 0])
    else:
        put("k", k[:, 0].to(cache["k"].dtype))
        put("v", v[:, 0].to(cache["v"].dtype))

    kv = {name: cache.get(name) for name in ("k", "v", "k_scale",
                                             "v_scale")}
    if q_split and not kv_split:
        # the replicated KV heads of this rank's query heads
        kv0, nkv_l, group = layers._kv_heads(cfg, sh.tp, sh.model)
        if nkv_l != nkv_c:
            kv = {name: None if t is None
                  else t.narrow(2, kv0, nkv_l).contiguous()
                  for name, t in kv.items()}
    else:
        nkv_l, group = nkv_c, nh_l // nkv_c
    qg = q[:, 0].reshape(b, nkv_l, group, hd)
    if paged:
        attn = dispatch.paged_decode_attention(
            qg, kv["k"], kv["v"], block_tables, pos,
            k_scale=kv["k_scale"], v_scale=kv["v_scale"],
            window=cfg.window or 0, backend=backend)
    else:
        put("k_pos", pos)
        attn = dispatch.decode_attention(
            qg, kv["k"], kv["v"], cache["k_pos"], pos,
            k_scale=kv["k_scale"], v_scale=kv["v_scale"],
            window=cfg.window or 0, block=attn_block, backend=backend)
    out = attn.to(x.dtype).reshape(b, 1, nh_l * hd)
    if q_split:
        return dense(out, params["wo"], policy, counter, seed=4,
                     shard=layers.row_shard(out, params["wo"], sh)), cache
    # sharded serving: all-gather the local heads before the replicated W_O
    # (DESIGN.md §9); identity elsewhere
    out = dist_ctx.gather_heads(out)
    return dense(out, params["wo"], policy, counter, seed=4), cache


# ---------------------------------------------------------------------------
# block application (prefill / decode)
# ---------------------------------------------------------------------------


def _ffn(bp: Params, cfg: ModelConfig, x: torch.Tensor, policy,
         counter) -> torch.Tensor:
    """The block's second half: x + FFN(norm(x)), the MoE FFN where the
    block has one (every token of the call competes for its capacity),
    else the MLP."""
    h2 = layers.rms_norm(x, bp["ln2"], cfg.norm_eps)
    if "moe" in bp:
        return x + moe.moe_ffn(bp["moe"], cfg, h2, policy, counter)
    return x + layers.mlp(bp["mlp"], h2, cfg.mlp_act, policy, counter,
                          d_ff=cfg.d_ff)


def _write_state(entry: Params, new: Params, active) -> None:
    """A recurrent layer's new state into its cache entry, in place; rows
    where ``active`` (B,) is False keep their old state."""
    for name, t in entry.items():
        n = new[name]
        if active is not None:
            n = torch.where(active.reshape((-1,) + (1,) * (n.dim() - 1)),
                            n, t)
        t.copy_(n)


_RECURRENT = {"rglru": ("rec", hybrid.rglru_block, hybrid.rglru_decode_step),
              "ssm": ("ssm", ssm.ssm_block, ssm.ssm_decode_step)}


def _apply_block(bp: Params, cfg: ModelConfig, kind: str, x: torch.Tensor,
                 positions, *, policy, counter, cache_entry=None, pos=None,
                 kv_offset=None, collect_kv: bool = False,
                 backend: Optional[str] = None, block_tables=None,
                 active=None, attn_block: Optional[tuple] = None):
    _check_kind(kind)
    h = layers.rms_norm(x, bp["ln1"], cfg.norm_eps)
    new_cache = cache_entry
    if kind != "attn":
        key, block, step = _RECURRENT[kind]
        if cache_entry is not None:
            out, new = step(bp[key], cfg, h, cache_entry, policy, counter)
            _write_state(cache_entry, new, active)
        else:
            out = block(bp[key], cfg, h, policy, counter)
    elif cache_entry is not None:
        out, new_cache = _attention_decode(bp["attn"], cfg, h, cache_entry,
                                           pos, policy, counter,
                                           kv_offset=kv_offset,
                                           backend=backend,
                                           block_tables=block_tables,
                                           active=active,
                                           attn_block=attn_block)
    else:
        out, kv = layers.attention(bp["attn"], cfg, h, positions,
                                   window=cfg.window, policy=policy,
                                   counter=counter, return_kv=collect_kv)
        if collect_kv:
            new_cache = kv
    x = x + out
    if "ln2" not in bp:                      # SSD blocks: norm → SSD only
        return x, new_cache
    return _ffn(bp, cfg, x, policy, counter), new_cache


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


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor, policy,
            counter):
    """The LM head over every row of x (under a policy its quantiser sees
    them all, as the reference's does), f32.  On the training mesh with
    the head split by vocab, this rank's columns: (B, S, V_pad / tp)."""
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    sh = layers.tp_shard()
    shard = None
    if sh is not None and head.shape[1] != cfg.vocab_padded():
        x = dist_ctx.copy_to_model(x)
        shard = layers.col_shard(x, head, sh)
    return dense(x, head, policy, counter, seed=9,
                 shard=shard).to(torch.float32)


# ---------------------------------------------------------------------------
# full-sequence forward (training, logits-only prefill)
# ---------------------------------------------------------------------------


def _embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings (vocab-parallel on the training mesh,
    ``layers.embed_lookup``), with a stub frontend's ``embeds`` (B, F, d)
    prepended in the embedding's dtype (the VLM's patch embeddings)."""
    x = layers.embed_lookup(params["embed"], tokens, cfg.vocab_padded())
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return x


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            embeds: Optional[torch.Tensor] = None, policy=None, counter=0,
            remat: bool = True) -> torch.Tensor:
    """Full-sequence forward → f32 logits (B, F + S, vocab_padded), no
    cache; F is the number of ``embeds`` rows prepended (0 without).

    ``remat`` recomputes each stacked layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), as the reference's
    ``jax.checkpoint`` of its scanned body; the remainder layers and the
    LM head are not recomputed, as there.  Under a kernel-backend policy a
    recomputed layer launches its dense products again.

    On the training mesh (``dist.ctx.train_shard``, DESIGN.md §5) params
    are this rank's blocks, tokens its data shard's rows, and the logits
    come out vocab-sharded, (B / dp, F + S, vocab_padded / tp), where the
    head is split."""
    x = _embed_inputs(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)

    def block(bp, kind, h):
        return _apply_block(bp, cfg, kind, h, positions, policy=policy,
                            counter=counter)[0]

    for bp, kind, _, r in _layers(params, cfg):
        if remat and r is not None:
            x = torch.utils.checkpoint.checkpoint(block, bp, kind, x,
                                                  use_reentrant=False)
        else:
            x = block(bp, kind, x)
    return _logits(params, cfg, x, policy, counter)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            embeds: Optional[torch.Tensor] = None, policy=None,
            counter=0) -> torch.Tensor:
    """Prefill forward, logits only (``forward`` without recomputation).
    The serving engine uses ``prefill_with_cache`` below, which also builds
    the ring decode cache."""
    return forward(params, cfg, tokens, embeds=embeds, policy=policy,
                   counter=counter, remat=False)


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
    logits = _logits(params, cfg, x, policy, counter)[:, :, : cfg.vocab_size]

    cap = min(cfg.window, max_len) if cfg.window else max_len

    def entry(kv):
        return _prefill_entry(cfg, kv, lengths, cap, kv_quant, kv_offset)

    stacked = [_stack(map(entry, kvs[(False, pos_i)]),
                      len(kvs[(False, pos_i)]))
               for pos_i in range(len(params["blocks"]))]
    remainder = [entry(kvs[(True, i)][0])
                 for i in range(len(params["remainder"]))]
    return logits, {"pos": lengths, "layers": stacked, "remainder": remainder}


# ---------------------------------------------------------------------------
# chunked ring prefill: chunk forward + ring-history join + ring scatter
# ---------------------------------------------------------------------------


def _ring_scatter_chunk(entry: Params, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, starts: torch.Tensor,
                        kv_quant: bool, kv_offset) -> None:
    """Merge one chunk's post-RoPE K/V (B, S, n_kv, hd) into a live ring
    entry, **in place**.  Gather-select form: ring slot j is *covered* iff
    some chunk position p ≡ j (mod cap) lies below ``starts + lengths``;
    chunks are at most cap tokens (the engine clamps), so each slot is
    covered at most once and the others keep their bytes.  The int8 path
    quantises with counter = absolute position (+ per-request offset) and
    the decode step's element indices, so a chunk writes the codes
    whole-prompt prefill or decode would have left at those positions."""
    cap = entry["k"].shape[1]
    b, s, nkv, hd = k.shape
    dev = k.device
    j = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    st = starts[:, None].to(torch.int32)
    t = torch.remainder(j - st, cap)                       # chunk index
    covered = t < lengths[:, None]                         # (B, cap)
    pj = st + t                                            # absolute position
    idx = torch.clamp(t, 0, s - 1).long()
    rows = torch.arange(b, device=dev)[:, None]
    gk, gv = k[rows, idx], v[rows, idx]                    # (B, cap, …)
    c3, c4 = covered[:, :, None], covered[:, :, None, None]
    entry["k_pos"].copy_(torch.where(covered, pj, entry["k_pos"]))
    if not kv_quant:
        entry["k"].copy_(torch.where(c4, gk.to(entry["k"].dtype), entry["k"]))
        entry["v"].copy_(torch.where(c4, gv.to(entry["v"].dtype), entry["v"]))
        return
    off = (torch.zeros((b,), dtype=torch.int32, device=dev)
           if kv_offset is None
           else torch.broadcast_to(kv_offset.to(torch.int32), (b,)))
    ctr = (pj + off[:, None])[:, :, None, None]
    idx4 = _kv_elem_idx(nkv, hd, dev)
    kq, ks = _kv_q8(gk, ctr, idx4, 101)
    vq, vs = _kv_q8(gv, ctr, idx4, 102)
    for name, new, gate in (("k", kq, c4), ("v", vq, c4),
                            ("k_scale", ks, c3), ("v_scale", vs, c3)):
        entry[name].copy_(torch.where(gate, new, entry[name]))


def _ring_chunk_attention(params: Params, cfg: ModelConfig, x: torch.Tensor,
                          positions: torch.Tensor, lengths: torch.Tensor,
                          starts: torch.Tensor, entry: Params, policy,
                          counter, kv_quant: bool, kv_offset) -> torch.Tensor:
    """Chunk attention of the chunked ring prefill: queries at absolute
    positions ``starts + t`` attend the in-batch chunk K/V
    (relative-causal, the cold prefill's ops) plus the slot's
    already-written history read from the live ring entry — positions with
    ``0 <= k_pos < start``, int8 codes dequantised per position — joined
    before the softmax, the paged prefill's prefix join on the ring.  The
    chunk K/V is then merged into the ring in place (after the history
    read).  Returns the attention block's output."""
    b, s, _ = x.shape
    hd, nh, nkv = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
    q, k, v = layers.qkv(params, cfg, x, positions, policy, counter)
    window = cfg.window or 0
    qg = q.reshape(b, s, nkv, nh // nkv, hd)
    m_ss = layers.make_causal_mask(s, s, window=window, device=x.device)
    logits_s = layers.grouped_logits(qg, k)
    logits_s = torch.where(m_ss[None, None, None, :, :], logits_s, -1e30)

    # history join: garbage slots carry k_pos = -1 or >= start and mask
    # out, so a dead decode row's writes never leak into chunk attention
    hk, hv = entry["k"], entry["v"]
    if "k_scale" in entry:
        hk = (hk.to(torch.float32)
              * (entry["k_scale"][..., None] / 127.0)).to(x.dtype)
        hv = (hv.to(torch.float32)
              * (entry["v_scale"][..., None] / 127.0)).to(x.dtype)
    kp = entry["k_pos"][:, None, :]                        # (B, 1, cap)
    vp = (kp >= 0) & (kp < starts[:, None, None])
    if window:
        vp = vp & (kp > positions[:, :, None] - window)
    logits_p = layers.grouped_logits(qg, hk)
    logits_p = torch.where(vp[:, None, None, :, :], logits_p, -1e30)
    cap = hk.shape[1]
    probs = layers.softmax(torch.cat([logits_p, logits_s], dim=-1),
                           dim=-1).to(x.dtype)
    out = (layers.grouped_values(probs[..., :cap].contiguous(), hv)
           + layers.grouped_values(probs[..., cap:].contiguous(), v))
    out = dense(dist_ctx.gather_heads(out.reshape(b, s, nh * hd)),
                params["wo"], policy, counter, seed=4)
    _ring_scatter_chunk(entry, k, v, lengths, starts, kv_quant, kv_offset)
    return out


def _ring_chunk_block(bp: Params, cfg: ModelConfig, x: torch.Tensor,
                      positions, lengths, starts, entry: Params, policy,
                      counter, kv_quant: bool, kv_offset) -> torch.Tensor:
    """One transformer block of the chunked ring prefill: ``_apply_block``
    with the history-joining attention above."""
    h = layers.rms_norm(x, bp["ln1"], cfg.norm_eps)
    x = x + _ring_chunk_attention(bp["attn"], cfg, h, positions, lengths,
                                  starts, entry, policy, counter, kv_quant,
                                  kv_offset)
    return _ffn(bp, cfg, x, policy, counter)


def prefill_with_cache_chunked(params: Params, cfg: ModelConfig,
                               tokens: torch.Tensor, lengths: torch.Tensor,
                               starts: torch.Tensor, cache: Params, *,
                               policy=None, counter=0, kv_quant: bool = False,
                               kv_offset=None):
    """Chunked ring prefill: one batched forward over right-padded prompt
    *chunks* (B, S) with lengths (B,) (0 = inactive row) at absolute
    positions ``starts + t``, merging their K/V into the live ring cache
    in place.  A continuation chunk (``starts[b] > 0``) does not recompute
    earlier tokens: each layer reads their K/V back from the slot's ring
    and joins it before the softmax.  Chunks must be at most the ring's
    capacity (the engine clamps).  Returns ``(logits (B, S, vocab_size)
    f32, cache)``: the live cache, its layer tensors written in place,
    ``pos`` = ``starts + lengths`` for active rows."""
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) != "attn":
            raise ValueError("chunked prefill requires attention-only layers")
    x = params["embed"][tokens]
    b, s, _ = x.shape
    lengths = lengths.to(torch.int32)
    starts = starts.to(torch.int32)
    positions = starts[:, None] + torch.arange(s, dtype=torch.int32,
                                               device=x.device)[None, :]
    for bp, kind, pos_i, r in _layers(params, cfg):
        entry = (_index(cache["layers"][pos_i], r) if r is not None
                 else cache["remainder"][pos_i])
        x = _ring_chunk_block(bp, cfg, x, positions, lengths, starts, entry,
                              policy, counter, kv_quant, kv_offset)
    logits = _logits(params, cfg, x, policy, counter)[:, :, : cfg.vocab_size]
    return logits, {"pos": torch.where(lengths > 0, starts + lengths,
                                       cache["pos"].to(torch.int32)),
                    "layers": cache["layers"],
                    "remainder": cache["remainder"]}


# ---------------------------------------------------------------------------
# paged prefill: suffix forward + prefix gather + block-pool scatter
# ---------------------------------------------------------------------------


def _gather_prefix(entry: Params, block_tables: torch.Tensor,
                   prefix_blocks: int):
    """The leading ``prefix_blocks`` logical blocks of every slot, gathered
    from one layer's pool → K, V (B, prefix_blocks·bs, n_kv, hd) and, for
    an int8 pool, the scales (B, prefix_blocks·bs, n_kv), else None.
    Unallocated entries point at the trash block; the caller masks those
    positions (implicit position ≥ the slot's start)."""
    bt = block_tables[:, :prefix_blocks].long()                # (B, P)
    b, p = bt.shape

    def gather(t):
        g = t[bt]                                              # (B, P, bs, …)
        return g.reshape((b, p * g.shape[2]) + g.shape[3:])

    scales = ([gather(entry["k_scale"]), gather(entry["v_scale"])]
              if "k_scale" in entry else [None, None])
    return [gather(entry["k"]), gather(entry["v"])] + scales


def _paged_scatter_entry(entry: Params, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, starts: torch.Tensor,
                         block_tables: torch.Tensor, kv_quant: bool,
                         kv_offset) -> None:
    """Write one layer's suffix K/V (post-RoPE, (B, S, n_kv, hd)) into its
    pool blocks, **in place**.  Suffix token s lands in logical block
    ``starts // bs + s // bs`` at in-block slot ``s % bs`` (starts are
    block-aligned); blocks past the suffix length go to the trash block.
    The int8 path quantises with counter = absolute position (+ per-request
    offset) and the decode step's element indices, so the codes are bit
    for bit what token-by-token decode would have written — the contract
    behind prefix sharing (DESIGN.md §6)."""
    nbp, bs = entry["k"].shape[0], entry["k"].shape[1]
    trash = nbp - 1
    b, s, nkv, hd = k.shape
    dev = k.device
    nbmax = block_tables.shape[1]
    s_pad = -(-s // bs) * bs
    if s_pad != s:
        pad = (0, 0, 0, 0, 0, s_pad - s)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    n_jb = s_pad // bs
    jb = torch.arange(n_jb, dtype=torch.int32, device=dev)[None, :]
    needed = jb * bs < lengths[:, None]                           # (B, JB)
    tj = torch.clamp(torch.div(starts, bs, rounding_mode="floor")[:, None]
                     + jb, 0, nbmax - 1)
    phys = torch.where(needed, block_tables.gather(1, tj.long()),
                       trash).reshape(-1).long()                  # (B·JB,)

    def blocks(t):
        return t.reshape((b * n_jb, bs) + t.shape[2:])

    if not kv_quant:
        entry["k"][phys] = blocks(k.to(entry["k"].dtype))
        entry["v"][phys] = blocks(v.to(entry["v"].dtype))
        return
    off = (torch.zeros((b,), dtype=torch.int32, device=dev)
           if kv_offset is None
           else torch.broadcast_to(kv_offset.to(torch.int32), (b,)))
    pos_pad = starts[:, None] + torch.arange(s_pad, dtype=torch.int32,
                                             device=dev)[None, :]
    ctr = (pos_pad + off[:, None])[:, :, None, None]          # (B, S_pad, 1, 1)
    idx4 = _kv_elem_idx(nkv, hd, dev)
    kq, ks = _kv_q8(k, ctr, idx4, 101)
    vq, vs = _kv_q8(v, ctr, idx4, 102)
    entry["k"][phys] = blocks(kq)
    entry["v"][phys] = blocks(vq)
    entry["k_scale"][phys] = blocks(ks)
    entry["v_scale"][phys] = blocks(vs)


def _paged_prefill_attention(params: Params, cfg: ModelConfig,
                             x: torch.Tensor, positions: torch.Tensor,
                             lengths: torch.Tensor, starts: torch.Tensor,
                             block_tables: torch.Tensor, entry: Params,
                             policy, counter, kv_quant: bool, kv_offset,
                             prefix_blocks: int) -> torch.Tensor:
    """Suffix attention of the paged prefill: queries at absolute positions
    ``starts + t`` attend the in-batch suffix K/V (relative-causal — the
    cold prefill's ``layers.attention`` ops, so a cold wave is exactly the
    ring prefill) plus, when ``prefix_blocks > 0``, the prefix K/V gathered
    from the pool (int8 codes dequantised per position), joined *before*
    the softmax so a prefix-hit request sees one distribution over its
    whole history.  The suffix K/V is then scattered into the pool in
    place (after the gather, so a layer reads its pool before writing
    it).  Returns the attention block's output."""
    b, s, _ = x.shape
    hd, nh, nkv = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
    q, k, v = layers.qkv(params, cfg, x, positions, policy, counter)
    window = cfg.window or 0
    qg = q.reshape(b, s, nkv, nh // nkv, hd)
    m_ss = layers.make_causal_mask(s, s, window=window, device=x.device)
    logits_s = layers.grouped_logits(qg, k)
    logits_s = torch.where(m_ss[None, None, None, :, :], logits_s, -1e30)

    if prefix_blocks:
        pk, pv, pks, pvs = _gather_prefix(entry, block_tables, prefix_blocks)
        if pks is not None:
            pk = (pk.to(torch.float32) * (pks[..., None] / 127.0)).to(x.dtype)
            pv = (pv.to(torch.float32) * (pvs[..., None] / 127.0)).to(x.dtype)
        s_pre = pk.shape[1]
        kp = torch.arange(s_pre, dtype=torch.int32,
                          device=x.device)[None, None, :]     # implicit pos
        vp = kp < starts[:, None, None]                       # (B, S, S_pre)
        if window:
            vp = vp & (kp > positions[:, :, None] - window)
        logits_p = layers.grouped_logits(qg, pk)
        logits_p = torch.where(vp[:, None, None, :, :], logits_p, -1e30)
        probs = layers.softmax(torch.cat([logits_p, logits_s], dim=-1),
                               dim=-1).to(x.dtype)
        out = (layers.grouped_values(probs[..., :s_pre].contiguous(), pv)
               + layers.grouped_values(probs[..., s_pre:].contiguous(), v))
    else:
        probs = layers.softmax(logits_s, dim=-1).to(x.dtype)
        out = layers.grouped_values(probs, v)
    out = dense(dist_ctx.gather_heads(out.reshape(b, s, nh * hd)),
                params["wo"], policy, counter, seed=4)
    _paged_scatter_entry(entry, k, v, lengths, starts, block_tables,
                         kv_quant, kv_offset)
    return out


def _paged_prefill_block(bp: Params, cfg: ModelConfig, x: torch.Tensor,
                         positions, lengths, starts, block_tables,
                         entry: Params, policy, counter, kv_quant: bool,
                         kv_offset, prefix_blocks: int) -> torch.Tensor:
    """One transformer block of the paged prefill: ``_apply_block`` with
    the prefix-aware attention above in place of ``layers.attention``."""
    h = layers.rms_norm(x, bp["ln1"], cfg.norm_eps)
    x = x + _paged_prefill_attention(
        bp["attn"], cfg, h, positions, lengths, starts, block_tables, entry,
        policy, counter, kv_quant, kv_offset, prefix_blocks)
    return _ffn(bp, cfg, x, policy, counter)


def prefill_with_cache_paged(params: Params, cfg: ModelConfig,
                             tokens: torch.Tensor, lengths: torch.Tensor,
                             starts: torch.Tensor,
                             block_tables: torch.Tensor, cache: Params, *,
                             policy=None, counter=0, kv_quant: bool = False,
                             kv_offset=None, prefix_blocks: int = 0):
    """Batched paged prefill: one forward over right-padded prompt
    *suffixes* (B, S) with lengths (B,) (0 = inactive row) that writes
    their K/V into the pool blocks named by ``block_tables`` (B, nbmax),
    in place.

    A prefix-cache hit sets ``starts[b] > 0`` (a multiple of the block
    size): tokens before it are not recomputed — their K/V is gathered from
    the shared pool blocks inside each layer's attention, over the first
    ``prefix_blocks`` logical blocks (0 on cold waves, which makes this
    exactly the cold batched prefill).  Returns ``(logits (B, S,
    vocab_size) f32, cache)``: the live cache, its layer tensors written in
    place, ``pos`` = ``starts + lengths`` for active rows, and
    ``block_tables`` installed.
    """
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) != "attn":
            raise ValueError("paged prefill requires attention-only layers")
    x = params["embed"][tokens]
    b, s, _ = x.shape
    dev = x.device
    lengths = lengths.to(torch.int32)
    starts = starts.to(torch.int32)
    block_tables = block_tables.to(torch.int32)
    positions = starts[:, None] + torch.arange(s, dtype=torch.int32,
                                               device=dev)[None, :]
    for bp, kind, pos_i, r in _layers(params, cfg):
        entry = (_index(cache["layers"][pos_i], r) if r is not None
                 else cache["remainder"][pos_i])
        x = _paged_prefill_block(bp, cfg, x, positions, lengths, starts,
                                 block_tables, entry, policy, counter,
                                 kv_quant, kv_offset, prefix_blocks)
    logits = _logits(params, cfg, x, policy, counter)[:, :, : cfg.vocab_size]
    return logits, {"pos": torch.where(lengths > 0, starts + lengths,
                                       cache["pos"].to(torch.int32)),
                    "block_tables": block_tables,
                    "layers": cache["layers"],
                    "remainder": cache["remainder"]}


def merge_cache(old: Params, new: Params, active: torch.Tensor) -> Params:
    """Per-slot cache insertion: rows of ``new`` where ``active`` (B,) bool
    replace rows of ``old``, **in place** in ``old``'s tensors (stacked
    entries carry batch at axis 1, remainder entries at axis 0; a tensor
    of ``new`` that is ``old``'s own is already in place).  Ring caches
    only: the paged prefill writes the pool in place."""
    if "block_tables" in old or "block_tables" in new:
        raise ValueError("merge_cache applies to ring caches only; the paged "
                         "prefill writes the pool in place")
    def sel(o_tree, n_tree, axis):
        for key, o in o_tree.items():
            if n_tree[key] is o:
                continue
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
                backend: Optional[str] = None,
                active: Optional[torch.Tensor] = None,
                attn_block: Optional[tuple] = None):
    """One decode step: (B,) tokens + cache → ((B, vocab_size) f32 logits,
    cache).  Every slot advances by one; the cache's layer tensors are
    updated in place and shared by the returned cache.  A cache carrying
    ``block_tables`` (B, nbmax) decodes against the paged block pool (one
    map for every layer's pool), else against the ring.  ``kv_offset``
    (B,) shifts the int8-KV dither counter per slot.  ``backend`` selects
    the decode-attention kernel backend (None: by device), ``attn_block``
    its ring tile (None: the dispatcher's default).  ``active``
    (B,) bool, where given: the rows that are False keep their recurrent
    state and ring contents as they were (their position the caller
    freezes).

    On the training mesh (``dist.ctx.train_shard_scope``, the reference's
    GSPMD decode under ``param_specs`` / ``cache_specs``) params and cache
    are this rank's blocks (``interop.shard_train_params``,
    ``interop.shard_cache``) and ``token`` its data shard's rows: the
    embedding and the head are vocab-parallel, the logits gathered over
    'model'; attention, the MLP and the recurrent layers run their
    tensor-parallel forms."""
    x = layers.embed_lookup(params["embed"], token[:, None],
                            cfg.vocab_padded())
    b = x.shape[0]
    pos = torch.broadcast_to(cache["pos"].to(torch.int32), (b,)).contiguous()
    block_tables = cache.get("block_tables")
    if block_tables is not None:
        block_tables = block_tables.to(torch.int32).contiguous()
    positions = pos[:, None]
    for bp, kind, pos_i, r in _layers(params, cfg):
        entry = (_index(cache["layers"][pos_i], r) if r is not None
                 else cache["remainder"][pos_i])
        x, _ = _apply_block(bp, cfg, kind, x, positions, policy=policy,
                            counter=counter, cache_entry=entry, pos=pos,
                            kv_offset=kv_offset, backend=backend,
                            block_tables=block_tables, active=active,
                            attn_block=attn_block)
    logits = _gather_vocab(_logits(params, cfg, x, policy, counter), cfg)
    new_cache = {"pos": pos + 1, "layers": cache["layers"],
                 "remainder": cache["remainder"]}
    if block_tables is not None:
        new_cache["block_tables"] = cache["block_tables"]
    return logits, new_cache


def _gather_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A decode step's (B, 1, V) logits → (B, vocab_size): a rank's
    vocab columns of the training layout's head all-gathered over
    'model' first."""
    if logits.shape[-1] != cfg.vocab_padded():
        logits = dist_ctx.gather_from_model(logits, logits.dim() - 1,
                                            reduce_grad=False)
    return logits[:, 0, : cfg.vocab_size]


# ---------------------------------------------------------------------------
# speculative verify: K-token scoring + bulk commit (DESIGN.md §14)
# ---------------------------------------------------------------------------


# The library ops of a verify forward, each computed by torch (cuBLAS on the
# card) with a summation order the library may choose by the row count.
VERIFY_OPS = ("rms_norm", "wq", "wk", "wv", "wo", "wg", "wu", "wd",
              "lm_head")


def _rowwise(fn, x: torch.Tensor, fused: bool) -> torch.Tensor:
    """``fn`` over the K rows of x (B, K, ·): at once when ``fused``, else
    on each contiguous (B, 1, ·) row (decode's own shape), stacked."""
    if fused:
        return fn(x)
    return torch.cat([fn(x[:, t:t + 1].contiguous())
                      for t in range(x.shape[1])], dim=1)


def _rms_norm_rows(x: torch.Tensor, gamma: torch.Tensor, eps: float,
                   fused: bool) -> torch.Tensor:
    """``layers.rms_norm`` over the K rows of x (B, K, d).  Its one
    reduction, the mean square, runs over all rows at once when ``fused``,
    else per row on a contiguous (B, d) block — decode's layout — and its
    elementwise steps run over all rows either way."""
    if fused:
        return layers.rms_norm(x, gamma, eps)
    xf = x.to(torch.float32)
    sq = (xf * xf).transpose(0, 1).contiguous()                 # (K, B, d)
    var = torch.stack([torch.mean(sq[t], dim=-1, keepdim=True)
                       for t in range(sq.shape[0])], dim=1)     # (B, K, 1)
    return layers.rms_norm(x, gamma, eps, var=var)


def _verify_weights(params: Params, cfg: ModelConfig) -> Dict[str, Any]:
    """op name → the weight each op of ``VERIFY_OPS`` multiplies by (None
    for the norm), the first layer's (every layer has the same shapes)."""
    bp = next(_layers(params, cfg))[0]
    weights = {"rms_norm": None,
               "lm_head": (params["embed"].T if cfg.tie_embeddings
                           else params["lm_head"])}
    weights.update({n: bp["attn"][n] for n in ("wq", "wk", "wv", "wo")})
    weights.update({n: bp["mlp"][n] for n in ("wg", "wu", "wd")})
    return weights


def row_purity(params: Params, cfg: ModelConfig, batch: int, kq: int, *,
               seed: int = 0) -> Dict[str, int]:
    """For each op of ``VERIFY_OPS``: in how many outputs the op over
    (batch, kq) rows at once differs in its bits from the op on each
    (batch, 1, ·) row at decode's shape, on the params' device.  0 means
    the library sums each row in the same order whatever the row count at
    this shape, and ``verify_step`` may run that op fused (``fused_ops``).

    The inputs are made so that the order shows: a product's bf16 output
    hides most reorderings of its f32 sum, so each matmul gets operands of
    its weight's shape and layout whose first and last products are ±2²⁴
    around N(0, 1) terms — the f32 sum then depends on the order in nearly
    every output.  The norm's sum of squares cannot cancel, so its f32
    mean square is compared before rounding.  Inputs are seeded."""
    dev = params["embed"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for name, w in _verify_weights(params, cfg).items():
        width = cfg.d_model if w is None else w.shape[0]
        x = torch.randn((batch, kq, width), generator=gen, device=dev)
        if w is None:
            def op(a):
                af = a.to(torch.float32)
                return torch.mean(af * af, dim=-1, keepdim=True)
        else:
            x[..., 0] = x[..., -1] = 4096.0
            ws = torch.randn(w.shape, generator=gen, device=dev)
            ws[0], ws[-1] = 4096.0, -4096.0
            syn = torch.empty_like(w)                # w's strides (layout)
            syn.copy_(ws)

            def op(a, syn=syn):
                return dense(a, syn)
        x = x.to(params["embed"].dtype)
        fused, rows = _rowwise(op, x, True), _rowwise(op, x, False)
        out[name] = int((fused != rows).sum().item())
    return out


def shard_purity(params: Params, cfg: ModelConfig, batch: int, dp: int,
                 tp: int, rows: int = 1, *, seed: int = 0) -> Dict[str, int]:
    """For each op of ``VERIFY_OPS`` — and, for ``rows`` > 1 (a prefill
    call of ``rows`` tokens a slot), the prefill attention's two batched
    products (``attn_logits``, ``attn_values``) — in how many outputs the
    op at one shard's local shape of sharded serving (``batch / dp`` slots
    of ``rows`` tokens; the QKV products and the attention at ``1 / tp``
    of their heads when the heads shard) differs in its bits from the
    same slice of the op at the single-device shape, over every (data,
    model) shard, on the params' device.  0 for every op at every row
    count a run meets means the library sums each output in the same
    order at both shapes, so on this device the sharded stream is the
    single-device stream bit for bit; the operands are ``row_purity``'s
    (an order change shows in nearly every output).  ``rows`` is 1 for
    decode and a prefill bucket's length for prefill."""
    from repro_torch.dist.sharding import serve_heads_shardable

    dev = params["embed"].device
    dtype = params["embed"].dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    b = batch // dp
    split = serve_heads_shardable(cfg, tp)

    def operand(shape, lead=4096.0):
        """N(0, 1) with ±lead at both ends of the last (summed) dim."""
        x = torch.randn(shape, generator=gen, device=dev)
        x[..., 0], x[..., -1] = lead, lead
        return x

    def count(op, args, cut):
        """Differing outputs of ``op(*args)`` against its shards' ``op``
        on the operands cut by ``cut(d, m)`` (and the output likewise)."""
        full, bad = op(*args), 0
        for d in range(dp):
            for m in range(tp if split else 1):
                local = op(*(c(a, d, m) for c, a in zip(cut, args)))
                bad += int((local != cut[-1](full, d, m)).sum().item())
        return bad

    def rows_of(a, d, m):
        return a[d * b:(d + 1) * b].contiguous()

    out = {}
    for name, w in _verify_weights(params, cfg).items():
        width = cfg.d_model if w is None else w.shape[0]
        x = torch.randn((batch, rows, width), generator=gen, device=dev)
        syn = None
        if w is not None:
            x[..., 0] = x[..., -1] = 4096.0
            ws = torch.randn(w.shape, generator=gen, device=dev)
            ws[0], ws[-1] = 4096.0, -4096.0
            syn = torch.empty_like(w)                # w's strides (layout)
            syn.copy_(ws)
        x = x.to(dtype)
        cols = split and name in ("wq", "wk", "wv")
        n = (syn.shape[-1] // tp) if cols else None

        def op(a, wt):
            if wt is None:
                af = a.to(torch.float32)
                return torch.mean(af * af, dim=-1, keepdim=True)
            return dense(a, wt)

        def w_cut(wt, d, m):
            if wt is None or not cols:
                return wt
            return wt[:, m * n:(m + 1) * n].contiguous()

        def o_cut(o, d, m):
            o = o[d * b:(d + 1) * b]
            return o[..., m * n:(m + 1) * n] if cols else o

        out[name] = count(op, (x, syn), (rows_of, w_cut, o_cut))
    if rows > 1:
        nkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd()
        h = nkv // tp if split else nkv

        def heads(a, d, m, dim):
            a = a[d * b:(d + 1) * b]
            return a.narrow(dim, m * h, h).contiguous() if split else a

        q = operand((batch, rows, nkv, g, hd)).to(dtype)
        k = operand((batch, rows, nkv, hd)).to(dtype)
        k[..., -1] = -4096.0
        out["attn_logits"] = count(
            layers.grouped_logits, (q, k),
            (lambda a, d, m: heads(a, d, m, 2),
             lambda a, d, m: heads(a, d, m, 2),
             lambda a, d, m: heads(a, d, m, 1)))
        probs = operand((batch, nkv, g, rows, rows)).to(dtype)
        v = torch.randn((batch, rows, nkv, hd), generator=gen, device=dev)
        v[:, 0], v[:, -1] = 4096.0, -4096.0
        v = v.to(dtype)
        out["attn_values"] = count(
            layers.grouped_values, (probs, v),
            (lambda a, d, m: heads(a, d, m, 1),
             lambda a, d, m: heads(a, d, m, 2),
             lambda a, d, m: heads(a, d, m, 2)))
    return out


def _attention_verify(params: Params, cfg: ModelConfig, x: torch.Tensor,
                      cache: Params, pos: torch.Tensor, policy, counter,
                      kv_offset=None, alive=None, wcap=None,
                      backend: Optional[str] = None,
                      block_tables: Optional[torch.Tensor] = None,
                      fused_ops=frozenset(),
                      attn_block: Optional[tuple] = None):
    """K-token verify attention against one layer's cache entry: the
    reference's ``_attention_verify``.  x: (B, K, d) normed hidden rows;
    row t scores position ``pos + t``.  Returns (B, K, d).

    Row purity: row t must be bit for bit what ``_attention_decode`` at
    ``pos + t`` computes.  Rope, the KV quantiser and the writes are
    elementwise per (row, position) and run over (B, K) at once; attention
    goes through the verify kernel, whose row t is the decode kernel at
    ``pos + t`` at the same tile (``attn_block``, decode's); each
    projection runs fused over the K rows only when named
    in ``fused_ops`` (see ``row_purity``), else per row at decode's own
    (B, 1, d) shape.

    All K positions are written first, **in place**; the per-row causal
    mask hides later rows' positions from earlier rows as empty slots are
    hidden in decode.  Row t of slot b writes only when ``alive[b]`` and
    ``t < wcap[b]``: a gated ring write keeps the slot's old bytes, a gated
    paged write lands in the trash block, so the verify forward never
    dirties state the commit cannot account for.
    """
    b, kq = x.shape[0], x.shape[1]
    hd, nh, nkv = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
    dev = x.device
    paged = block_tables is not None

    def proj(name, seed, heads):
        out = _rowwise(lambda a: dense(a, params[name], policy, counter,
                                       seed=seed), x, name in fused_ops)
        return out.reshape(b, kq, heads, hd)

    q, k, v = proj("wq", 1, nh), proj("wk", 2, nkv), proj("wv", 3, nkv)
    if cfg.qkv_bias and "bq" in params:
        q = q + params["bq"].reshape(1, 1, nh, hd)
        k = k + params["bk"].reshape(1, 1, nkv, hd)
        v = v + params["bv"].reshape(1, 1, nkv, hd)
    offs = torch.arange(kq, dtype=torch.int32, device=dev)[None, :]
    posv = pos[:, None] + offs                                  # (B, K)
    q = layers.rope(q, posv, cfg.rope_theta)
    k = layers.rope(k, posv, cfg.rope_theta)

    if alive is None:
        alive = torch.ones((b,), dtype=torch.bool, device=dev)
    if wcap is None:
        wcap = torch.full((b,), kq, dtype=torch.int32, device=dev)
    writable = (offs < wcap.to(torch.int32)[:, None]) & alive[:, None]

    width = cache["k"].shape[1]                     # ring cap or block size
    if not paged and kq > width:
        raise ValueError(f"{kq} verify rows do not fit a ring of {width} "
                         "slots")
    slot = torch.remainder(posv, width).long()
    if paged:
        trash = cache["k"].shape[0] - 1
        logical = torch.clamp(torch.div(posv, width, rounding_mode="floor"),
                              0, block_tables.shape[1] - 1)
        index = torch.where(writable, block_tables.gather(1, logical.long()),
                            trash).long()
    else:
        index = torch.arange(b, device=dev)[:, None].expand(b, kq)

    def write(name, new):
        """Position (b, t) of ``cache[name]`` ← new[b, t] where writable:
        paged gated writes go to the trash block, ring ones keep the old
        bytes (no two (b, t) share a ring slot: K ≤ cap)."""
        t = cache[name]
        if not paged:
            gate = writable.reshape(writable.shape + (1,) * (new.dim() - 2))
            new = torch.where(gate, new, t[index, slot])
        t[index, slot] = new

    if cache["k"].dtype == torch.int8:
        ctr = posv if kv_offset is None else posv + kv_offset[:, None]
        ctr4 = ctr.reshape(b, kq, 1, 1)
        idx4 = _kv_elem_idx(nkv, hd, dev)
        k8, ks = _kv_q8(k, ctr4, idx4, 101)
        v8, vs = _kv_q8(v, ctr4, idx4, 102)
        for name, new in (("k", k8), ("v", v8), ("k_scale", ks),
                          ("v_scale", vs)):
            write(name, new)
    else:
        write("k", k.to(cache["k"].dtype))
        write("v", v.to(cache["v"].dtype))

    qg = q.reshape(b, kq, nkv, nh // nkv, hd)
    if paged:
        attn = dispatch.paged_verify_attention(
            qg, cache["k"], cache["v"], block_tables, pos,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
            window=cfg.window or 0, backend=backend)
    else:
        write("k_pos", posv)
        attn = dispatch.verify_attention(
            qg, cache["k"], cache["v"], cache["k_pos"], pos,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
            window=cfg.window or 0, block=attn_block, backend=backend)
    out = dist_ctx.gather_heads(attn.to(x.dtype).reshape(b, kq, nh * hd))
    return _rowwise(lambda a: dense(a, params["wo"], policy, counter, seed=4),
                    out, "wo" in fused_ops)


def _apply_verify_block(bp: Params, cfg: ModelConfig, kind: str,
                        x: torch.Tensor, *, policy, counter,
                        cache_entry: Params, pos: torch.Tensor, kv_offset,
                        alive, wcap, backend: Optional[str], block_tables,
                        fused_ops, attn_block: Optional[tuple] = None):
    """One transformer block of the verify forward over the K hidden rows
    x (B, K, d): ``_apply_block``'s decode ops — the norms and the SwiGLU
    MLP's projections per row unless named in ``fused_ops``, its
    elementwise ops over all rows — around the verify attention.  MoE
    blocks have no verify form (``registry.supports_spec_decode``)."""
    _check_kind(kind)
    if "moe" in bp:
        raise ValueError("verify has no MoE form: capacity ranks would couple "
                         "a verify row to its own later draft positions")
    norm = "rms_norm" in fused_ops

    def rows(name, a, fn):
        return _rowwise(fn, a, name in fused_ops)

    h = _rms_norm_rows(x, bp["ln1"], cfg.norm_eps, norm)
    x = x + _attention_verify(bp["attn"], cfg, h, cache_entry, pos, policy,
                              counter, kv_offset=kv_offset, alive=alive,
                              wcap=wcap, backend=backend,
                              block_tables=block_tables, fused_ops=fused_ops,
                              attn_block=attn_block)
    h2 = _rms_norm_rows(x, bp["ln2"], cfg.norm_eps, norm)
    mp = bp["mlp"]
    layers._check_act(cfg.mlp_act)
    g = rows("wg", h2, lambda a: dense(a, mp["wg"], policy, counter, seed=5))
    u = rows("wu", h2, lambda a: dense(a, mp["wu"], policy, counter, seed=6))
    gf = g.to(torch.float32)
    hm = (gf * torch.sigmoid(gf)).to(h2.dtype) * u     # layers.mlp's SwiGLU
    return x + rows("wd", hm, lambda a: dense(a, mp["wd"], policy, counter,
                                              seed=7))


def verify_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, *, policy=None, counter=0, kv_offset=None,
                alive=None, wcap=None, backend: Optional[str] = None,
                fused_ops=frozenset(), attn_block: Optional[tuple] = None):
    """Score K draft positions per slot in one forward → ((B, K,
    vocab_size) f32 logits, cache with the K positions written in place).

    ``tokens`` (B, K): each slot's last committed token, then K - 1 drafts.
    ``logits[:, t]`` is bit for bit the (B, vocab_size) logits
    ``decode_step`` returns at position ``pos + t`` after sequentially
    decoding ``tokens[:, 1..t]`` — what makes a speculative stream equal
    to the plain one.  ``cache["pos"]`` is not advanced: the caller commits
    the accepted prefix with ``spec_commit``.  ``alive`` (B,) bool and
    ``wcap`` (B,) int bound the writes (see ``_attention_verify``).
    ``fused_ops`` names the ops of ``VERIFY_OPS`` to run over all K rows at
    once; the rest run per row at decode's shape (the default: all), which
    is row-pure whatever the library does (see ``row_purity``).
    ``attn_block``: the ring tile, ``decode_step``'s.
    """
    b, kq = tokens.shape
    pos = torch.broadcast_to(cache["pos"].to(torch.int32), (b,)).contiguous()
    block_tables = cache.get("block_tables")
    if block_tables is not None:
        block_tables = block_tables.to(torch.int32).contiguous()
    x = params["embed"][tokens]
    for bp, kind, pos_i, r in _layers(params, cfg):
        entry = (_index(cache["layers"][pos_i], r) if r is not None
                 else cache["remainder"][pos_i])
        x = _apply_verify_block(bp, cfg, kind, x, policy=policy,
                                counter=counter, cache_entry=entry, pos=pos,
                                kv_offset=kv_offset, alive=alive, wcap=wcap,
                                backend=backend, block_tables=block_tables,
                                fused_ops=fused_ops, attn_block=attn_block)
    xn = _rms_norm_rows(x, params["final_norm"], cfg.norm_eps,
                        "rms_norm" in fused_ops)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = _rowwise(lambda a: dense(a, head, policy, counter, seed=9), xn,
                      "lm_head" in fused_ops)
    return logits.to(torch.float32)[:, :, : cfg.vocab_size], cache


def spec_commit(cache: Params, new_pos: torch.Tensor, written: torch.Tensor,
                *, draft_k: int) -> Params:
    """Bulk-commit a verified window, **in place**: ``pos`` becomes
    ``new_pos`` and the rejected suffix — draft positions in ``[new_pos,
    pos + written)`` — is scrubbed back to the never-written state (codes,
    scales and bf16 K/V 0, ring ``k_pos`` -1), so the cache holds the bytes
    of one that only ever decoded the accepted tokens (the reference's
    ``spec_commit``).

    The accepted prefix needs no touch-up: the dither codes are
    position-pure, so what the verify forward wrote below ``new_pos`` is
    what sequential decode writes.  ``written`` (B,) is the per-row write
    budget the verify forward ran with (0 for dead rows).
    """
    old = cache["pos"].to(torch.int32)
    b = old.shape[0]
    dev = old.device
    new_pos = new_pos.to(torch.int32)
    offs = torch.arange(draft_k, dtype=torch.int32, device=dev)[None, :]
    p = old[:, None] + offs                                     # (B, K)
    stale = ((offs < written.to(torch.int32)[:, None])
             & (p >= new_pos[:, None]))
    block_tables = cache.get("block_tables")
    paged = block_tables is not None

    def scrub(entry, lead):
        pre = (slice(None),) if lead else ()
        width = entry["k"].shape[len(pre) + 1]
        slot = torch.remainder(p, width).long()
        if paged:
            # non-stale positions scrub the trash block, which nothing reads
            trash = entry["k"].shape[len(pre)] - 1
            logical = torch.clamp(torch.div(p, width, rounding_mode="floor"),
                                  0, block_tables.shape[1] - 1)
            index = torch.where(stale, block_tables.to(torch.int64).gather(
                1, logical.long()), trash)
        else:
            index = torch.arange(b, device=dev)[:, None].expand(b, draft_k)
        ix = pre + (index, slot)
        for name, t in entry.items():
            blank = torch.zeros((), dtype=t.dtype, device=dev)
            if name == "k_pos":
                blank = blank - 1
            if not paged:
                # ring: keep the bytes of positions that are not stale
                gate = stale.reshape((1,) * len(pre) + stale.shape
                                     + (1,) * (t.dim() - len(pre) - 2))
                blank = torch.where(gate, blank, t[ix])
            t[ix] = blank

    for entry in cache["layers"]:
        scrub(entry, True)
    for entry in cache["remainder"]:
        scrub(entry, False)
    cache["pos"] = new_pos
    return cache
