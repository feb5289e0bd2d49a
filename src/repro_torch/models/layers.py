"""Model layers of the port (counterpart of the reference's
``models/layers.py``), as plain functions on tensors.

Params are nested dicts whose leaves carry the reference's names and
layouts.  Every step keeps the reference's dtype, so the CPU parity tests
hold at tight tolerances: matmuls and einsums run on bf16 operands and come
out in bf16, ``rope`` and the norms compute in f32 and cast back, softmax
runs in f32 and is cast back to bf16.  Prefill attention stays plain torch
ops, as the reference leaves it to XLA rather than a kernel.

On the training mesh (``dist.ctx.train_shard``, DESIGN.md §5) the layers
run Megatron tensor parallelism on 'model' over the blocks that
``dist.sharding.train_param_specs`` gives each rank: attention on local
heads (``copy_to_model`` before QKV, W_O row-parallel), or, where the head
count does not divide the 'model' axis, the reference's sequence split
(:func:`_attention_seq`); the MLP with up/gate column-parallel and down
row-parallel; the embedding vocab-parallel.  Each product tells ``dense``
where its operands sit in the reference's global ones
(``policy.ProductShard``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.dist import ctx
from repro_torch.dist.sharding import ShardView
from repro_torch.models.config import ModelConfig
from repro_torch.numerics.policy import ProductShard, dense, matmul

Params = Dict[str, Any]

__all__ = ["rms_norm", "layer_norm", "rope", "attention", "qkv",
           "grouped_logits", "grouped_values", "mlp", "gelu", "softmax",
           "make_causal_mask", "init_attention", "init_mlp",
           "init_embedding", "embed_lookup", "act_view", "col_shard",
           "row_shard", "tp_shard"]


def _init(gen: torch.Generator, shape, scale=None, device="cuda"):
    """N(0, 1/fan_in) (or ``scale``) weights in bf16, drawn in f32 from
    ``gen`` on ``device``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * scale).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# norms & rotary
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
             var: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm in f32, cast back, times gamma.  ``var``: the mean square
    over the last dim (keepdim), when the caller computed it already."""
    xf = x.to(torch.float32)
    if var is None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (mean, then the mean square of the centred
    values), cast back, then ``* gamma + beta`` in x's dtype, in the
    reference's order."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    xc = xf - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding in f32, cast back.  x: (B, S, H, hd),
    positions: (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    ar = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-math.log(theta) * ar / half)
    ang = positions[..., None].to(torch.float32) * freqs     # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``'s formula: exp(x - max) / sum, in x's dtype."""
    unnorm = torch.exp(x - torch.amax(x, dim=dim, keepdim=True))
    return unnorm / torch.sum(unnorm, dim=dim, keepdim=True)


# ---------------------------------------------------------------------------
# attention (GQA; causal, bidirectional or cross; full sequences)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   device="cuda") -> Params:
    d, hd = cfg.d_model, cfg.hd()
    p = {
        "wq": _init(gen, (d, cfg.n_heads * hd), device=device),
        "wk": _init(gen, (d, cfg.n_kv_heads * hd), device=device),
        "wv": _init(gen, (d, cfg.n_kv_heads * hd), device=device),
        "wo": _init(gen, (cfg.n_heads * hd, d), device=device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((width * hd,), dtype=torch.bfloat16,
                                  device=device)
    return p


def make_causal_mask(s_q: int, s_k: int, window: int = 0,
                     device="cuda") -> torch.Tensor:
    """(s_q, s_k) bool mask, query row 0 at position 0."""
    q_pos = torch.arange(s_q, device=device)[:, None]
    k_pos = torch.arange(s_k, device=device)[None, :]
    m = k_pos <= q_pos
    if window:
        m = m & (k_pos > q_pos - window)
    return m


def qkv(params: Params, cfg: ModelConfig, x: torch.Tensor,
        positions: torch.Tensor, policy=None, counter=0):
    """The post-RoPE projections of a full sequence: q (B, S, H, hd), k and
    v (B, S, n_kv_heads, hd), in x's dtype."""
    b, s, _ = x.shape
    hd, nh, nkv = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
    q = dense(x, params["wq"], policy, counter, seed=1)
    k = dense(x, params["wk"], policy, counter, seed=2)
    v = dense(x, params["wv"], policy, counter, seed=3)
    if cfg.qkv_bias and "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = rope(q.reshape(b, s, nh, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, nkv, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, nkv, hd)


def grouped_logits(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Scores of queries qg (B, Sq, n_kv, group, hd) against keys
    k (B, Sk, n_kv, hd) → (B, n_kv, group, Sq, Sk) f32, divided by
    sqrt(hd).  A batched matmul over (B, n_kv): f32 accumulation, rounded
    to the operands' dtype as the reference's einsum, then cast."""
    b, s_q, nkv, group, hd = qg.shape
    qh = qg.permute(0, 2, 3, 1, 4).reshape(b, nkv, group * s_q, hd)
    kt = k.permute(0, 2, 3, 1)                              # (B, nkv, hd, Sk)
    logits = matmul(qh, kt).reshape(b, nkv, group, s_q, k.shape[1])
    return logits.to(torch.float32) / math.sqrt(hd)


def grouped_values(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B, n_kv, group, Sq, Sk) times values v (B, Sk, n_kv, hd) →
    (B, Sq, n_kv, group, hd) in the operands' dtype."""
    b, nkv, group, s_q, s_k = probs.shape
    vh = v.permute(0, 2, 1, 3)                              # (B, nkv, Sk, hd)
    out = matmul(probs.reshape(b, nkv, group * s_q, s_k), vh)
    return out.reshape(b, nkv, group, s_q, v.shape[3]).permute(0, 3, 1, 2, 4)


def attention(params: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              window: int = 0, kv_src: Optional[torch.Tensor] = None,
              policy=None, counter=0, use_rope: bool = True,
              return_kv: bool = False):
    """GQA attention over a full sequence (prefill, training, the
    encoder).

    x: (B, S, d) bf16, positions: (B, S).  ``causal`` masks future keys
    (and, with ``window``, keys a window or more behind); ``causal=False``
    attends every key.  ``kv_src`` (B, S_k, d): cross-attention, keys and
    values projected from it, no RoPE (unmasked with ``causal=False``, as
    its callers pass it); ``use_rope=False`` skips RoPE on self-attention
    too (the encoder).  Returns ``(out,
    kv)``: ``kv`` is the post-RoPE ``(k, v)`` of this call's tokens, each
    (B, S_k, n_kv_heads, hd), when ``return_kv`` (the batched prefill
    scatters them into the ring cache), else None.  The score product
    comes out in bf16 before the f32 cast, as the reference's einsum
    does.
    """
    sh = tp_shard()
    if sh is not None:
        if return_kv:
            raise NotImplementedError(
                "attention at tp > 1 returns no per-call K/V (return_kv): "
                "the training mesh fills no cache, and sharded serving "
                "runs under serve_shard_scope")
        mode = dict(causal=causal, window=window, kv_src=kv_src,
                    use_rope=use_rope and kv_src is None)
        if not ctx.seq_shard_attention(cfg.n_heads):
            return _attention_tp(params, cfg, x, positions, policy,
                                 counter, sh, **mode), None
        if x.shape[1] > 1 and x.shape[1] % sh.tp == 0:
            return _attention_seq(params, cfg, x, positions, policy,
                                  counter, sh, **mode), None
        # the reference's fallback: S not divisible either — every 'model'
        # rank computes the whole (replicated) attention
    b, s, _ = x.shape
    hd, nh, nkv = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
    if kv_src is None and use_rope:
        q, k, v = qkv(params, cfg, x, positions, policy, counter)
    else:
        src = x if kv_src is None else kv_src
        q = dense(x, params["wq"], policy, counter, seed=1)
        k = dense(src, params["wk"], policy, counter, seed=2)
        v = dense(src, params["wv"], policy, counter, seed=3)
        if cfg.qkv_bias and "bq" in params:
            q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
        q = q.reshape(b, s, nh, hd)
        k = k.reshape(b, src.shape[1], nkv, hd)
        v = v.reshape(b, src.shape[1], nkv, hd)
    kv_out = (k, v) if return_kv else None

    logits = grouped_logits(q.reshape(b, s, nkv, nh // nkv, hd), k)
    if causal:
        mask = make_causal_mask(s, k.shape[1], window=window,
                                device=x.device)
        logits = torch.where(mask[None, None, None, :, :], logits, -1e30)
    probs = softmax(logits, dim=-1).to(x.dtype)
    # sharded serving: the local heads all-gathered before the replicated
    # W_O (DESIGN.md §9); identity elsewhere
    out = ctx.gather_heads(grouped_values(probs, v).reshape(b, s, nh * hd))
    return dense(out, params["wo"], policy, counter, seed=4), kv_out


# ---------------------------------------------------------------------------
# the training mesh: where each product's operands sit
# ---------------------------------------------------------------------------


def tp_shard():
    """The active training shard when its 'model' axis splits anything
    (tp > 1), else None."""
    s = ctx.train_shard()
    return s if s is not None and s.tp > 1 else None


def act_view(x: torch.Tensor, sh, *, k_split: bool = False,
             seq: bool = False):
    """An activation's view and groups on the training mesh: x (B_l, …, K)
    holds the data shard's rows of the global (B, …, K) (offset ``data ·
    B_l``); ``seq``: also the 'model' rank's token shard of dim 1;
    ``k_split``: also its block of the last dim (the K-sharded input of a
    row-parallel product).  Returns ``(ShardView, groups)``: the groups
    that split x, over which its absmax is taken."""
    shape, off = list(x.shape), [0] * x.dim()
    shape[0], off[0] = x.shape[0] * sh.dp, sh.data * x.shape[0]
    if seq:
        shape[1], off[1] = x.shape[1] * sh.tp, sh.model * x.shape[1]
    if k_split:
        shape[-1], off[-1] = x.shape[-1] * sh.tp, sh.model * x.shape[-1]
    axes = ("data", "model") if seq or k_split else ("data",)
    return ShardView(tuple(shape), tuple(off)), sh.groups(*axes)


def col_shard(x: torch.Tensor, w: torch.Tensor, sh) -> ProductShard:
    """A column-parallel product: x replicated over 'model' (split over
    'data'), w this rank's block of columns."""
    xv, xg = act_view(x, sh)
    k, n = w.shape
    return ProductShard(xv, xg, ShardView((k, n * sh.tp), (0, sh.model * n)),
                        sh.groups("model"))


def row_shard(x: torch.Tensor, w: torch.Tensor, sh) -> ProductShard:
    """A row-parallel product: x this rank's K block (and data rows), w its
    block of rows; the partial sums are summed over 'model'."""
    xv, xg = act_view(x, sh, k_split=True)
    k, n = w.shape
    return ProductShard(xv, xg, ShardView((k * sh.tp, n), (sh.model * k, 0)),
                        sh.groups("model"), k_split=True)


def _kv_heads(cfg: ModelConfig, tp: int, model: int):
    """(first KV head, KV heads, query heads a KV head) of this 'model'
    rank's query heads when the KV projections stay replicated
    (``n_kv_heads`` does not divide ``tp``)."""
    nh_l, group = cfg.n_heads // tp, cfg.n_heads // cfg.n_kv_heads
    h0 = model * nh_l
    if nh_l % group == 0:
        return h0 // group, nh_l // group, group
    if group % nh_l == 0:
        return h0 // group, 1, nh_l
    raise NotImplementedError(
        f"{cfg.n_heads} query heads over {cfg.n_kv_heads} KV heads at tp "
        f"{tp}: a rank's query heads straddle KV groups")


def _attention_tp(params: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions, policy, counter, sh, *, causal: bool,
                  window: int, kv_src: Optional[torch.Tensor],
                  use_rope: bool) -> torch.Tensor:
    """Attention on this 'model' rank's heads (the head count divides
    tp): QKV column-parallel after ``copy_to_model``, W_O row-parallel
    (its partial sums reduced in ``dense``).  KV projections that the
    layout keeps replicated (``n_kv_heads`` does not divide tp) are
    computed whole and cut to the KV heads of the rank's query heads; their
    weights pass ``copy_to_model``, so their gradient, partial on each
    rank, is summed.  ``kv_src`` (cross-attention) enters through
    ``copy_to_model`` too: each rank's K/V products see only its heads,
    so the gradient flowing back into the encoder output is summed over
    'model' (without it the encoder's replicated leaves would drift
    apart between ranks)."""
    b, s, _ = x.shape
    hd, tp = cfg.hd(), sh.tp
    nh_l = cfg.n_heads // tp
    xin = ctx.copy_to_model(x)
    src = xin if kv_src is None else ctx.copy_to_model(kv_src)
    kv_split = params["wk"].shape[-1] != cfg.n_kv_heads * hd
    q = dense(xin, params["wq"], policy, counter, seed=1,
              shard=col_shard(xin, params["wq"], sh))
    wk, wv = params["wk"], params["wv"]
    if kv_split:
        k = dense(src, wk, policy, counter, seed=2,
                  shard=col_shard(src, wk, sh))
        v = dense(src, wv, policy, counter, seed=3,
                  shard=col_shard(src, wv, sh))
        nkv_l, group_l, kv0 = cfg.n_kv_heads // tp, cfg.n_heads // \
            cfg.n_kv_heads, None
    else:
        kv0, nkv_l, group_l = _kv_heads(cfg, tp, sh.model)
        k = dense(src, ctx.copy_to_model(wk), policy, counter, seed=2)
        v = dense(src, ctx.copy_to_model(wv), policy, counter, seed=3)
    if cfg.qkv_bias and "bq" in params:
        bk, bv = params["bk"], params["bv"]
        if not kv_split:
            bk, bv = ctx.copy_to_model(bk), ctx.copy_to_model(bv)
        q, k, v = q + params["bq"], k + bk, v + bv
    k = k.reshape(b, src.shape[1], -1, hd)
    v = v.reshape(b, src.shape[1], -1, hd)
    if kv0 is not None:
        k, v = k[:, :, kv0:kv0 + nkv_l], v[:, :, kv0:kv0 + nkv_l]
    q = q.reshape(b, s, nh_l, hd)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    logits = grouped_logits(q.reshape(b, s, nkv_l, group_l, hd), k)
    if causal:
        mask = make_causal_mask(s, k.shape[1], window=window,
                                device=x.device)
        logits = torch.where(mask[None, None, None, :, :], logits, -1e30)
    probs = softmax(logits, dim=-1).to(x.dtype)
    out = grouped_values(probs, v).reshape(b, s, nh_l * hd)
    return dense(out, params["wo"], policy, counter, seed=4,
                 shard=row_shard(out, params["wo"], sh))


def _attention_seq(params: Params, cfg: ModelConfig, x: torch.Tensor,
                   positions, policy, counter, sh, *, causal: bool,
                   window: int, kv_src: Optional[torch.Tensor],
                   use_rope: bool) -> torch.Tensor:
    """The reference's sequence split (``layers.py:133-135``), for a head
    count that does not divide tp: the QKV/O weights are replicated, each
    'model' rank takes its S/tp query rows at their global positions (RoPE
    and the causal mask offset), K and V come from ``gather_from_model``
    (self-attention) or from the whole ``kv_src`` (cross-attention, which
    the reference leaves unsplit), W_O runs on the rank's own rows, and
    the rows are gathered back.  The weights pass ``copy_to_model`` (each
    rank's gradient covers its own rows), and so do x and ``kv_src``
    (each rank reads its own rows of x, and uses all of ``kv_src`` for
    its own rows' scores)."""
    b, s, _ = x.shape
    hd, nh, nkv = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
    s_l = s // sh.tp
    s0 = sh.model * s_l
    xl = ctx.copy_to_model(x)[:, s0:s0 + s_l]
    w = {k: ctx.copy_to_model(t) for k, t in params.items()}
    xv, xg = act_view(xl, sh, seq=True)
    shard = ProductShard(xv, xg)
    src, src_shard = xl, shard
    if kv_src is not None:
        src = ctx.copy_to_model(kv_src)
        src_shard = ProductShard(*act_view(src, sh))
    q = dense(xl, w["wq"], policy, counter, seed=1, shard=shard)
    k = dense(src, w["wk"], policy, counter, seed=2, shard=src_shard)
    v = dense(src, w["wv"], policy, counter, seed=3, shard=src_shard)
    if cfg.qkv_bias and "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = q.reshape(b, s_l, nh, hd)
    k = k.reshape(b, src.shape[1], nkv, hd)
    v = v.reshape(b, src.shape[1], nkv, hd)
    if use_rope:
        pos = positions[:, s0:s0 + s_l]
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    if kv_src is None:
        k = ctx.gather_from_model(k, 1)
        v = ctx.gather_from_model(v, 1)
    logits = grouped_logits(q.reshape(b, s_l, nkv, nh // nkv, hd), k)
    if causal:
        mask = make_causal_mask(s, k.shape[1], window=window,
                                device=x.device)[s0:s0 + s_l]
        logits = torch.where(mask[None, None, None, :, :], logits, -1e30)
    probs = softmax(logits, dim=-1).to(x.dtype)
    out = grouped_values(probs, v).reshape(b, s_l, nh * hd)
    ov, og = act_view(out, sh, seq=True)
    out = dense(out, w["wo"], policy, counter, seed=4,
                shard=ProductShard(ov, og))
    return ctx.gather_from_model(out, 1, reduce_grad=False)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                 vocab_padded: int) -> torch.Tensor:
    """``embed[tokens]``; on the training mesh with the embedding split by
    vocab (``embed`` this rank's rows), the vocab-parallel form: rows
    outside the rank's range masked to 0, then ``reduce_from_model`` —
    exact, as one rank holds each row."""
    sh = tp_shard()
    if sh is None or embed.shape[0] == vocab_padded:
        return embed[tokens]
    v_l = embed.shape[0]
    local = tokens - sh.model * v_l
    inside = (local >= 0) & (local < v_l)
    x = embed[local.clamp(0, v_l - 1)] * inside[..., None].to(embed.dtype)
    return ctx.reduce_from_model(x)


# ---------------------------------------------------------------------------
# MLP (SwiGLU or GELU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             act: str = "swiglu", device="cuda") -> Params:
    """SwiGLU ``{wg, wu, wd}``, or for ``act="gelu"`` the reference's GELU
    MLP ``{wu, wd, bu, bd}`` with zero bf16 biases."""
    _check_act(act)
    if act == "swiglu":
        return {"wg": _init(gen, (d_model, d_ff), device=device),
                "wu": _init(gen, (d_model, d_ff), device=device),
                "wd": _init(gen, (d_ff, d_model), device=device)}
    return {"wu": _init(gen, (d_model, d_ff), device=device),
            "wd": _init(gen, (d_ff, d_model), device=device),
            "bu": torch.zeros((d_ff,), dtype=torch.bfloat16, device=device),
            "bd": torch.zeros((d_model,), dtype=torch.bfloat16,
                              device=device)}


def _check_act(act: str) -> None:
    if act not in ("swiglu", "gelu"):
        raise ValueError(f"unknown mlp_act {act!r}")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation, in f32, cast
    back to x's dtype."""
    return torch.nn.functional.gelu(x.to(torch.float32),
                                    approximate="tanh").to(x.dtype)


def mlp(params: Params, x: torch.Tensor, act: str = "swiglu", policy=None,
        counter=0, d_ff: int = 0) -> torch.Tensor:
    """SwiGLU MLP (silu in f32, cast back, times the up projection), or
    the GELU MLP: up projection plus its bias, GELU, down projection plus
    its bias, each sum in bf16 as the reference's.

    On the training mesh, weights narrower than the global width ``d_ff``
    are this rank's blocks: up/gate column-parallel after
    ``copy_to_model``, down row-parallel."""
    _check_act(act)
    sh = tp_shard()
    split = sh is not None and d_ff and params["wd"].shape[0] != d_ff
    col = row = None
    if split:
        x = ctx.copy_to_model(x)
        col = col_shard(x, params["wu"], sh)
    if act == "swiglu":
        g = dense(x, params["wg"], policy, counter, seed=5, shard=col)
        u = dense(x, params["wu"], policy, counter, seed=6, shard=col)
        gf = g.to(torch.float32)
        h = (gf * torch.sigmoid(gf)).to(x.dtype) * u
        if split:
            row = row_shard(h, params["wd"], sh)
        return dense(h, params["wd"], policy, counter, seed=7, shard=row)
    h = gelu(dense(x, params["wu"], policy, counter, seed=5, shard=col)
             + params["bu"])
    if split:
        row = row_shard(h, params["wd"], sh)
    return dense(h, params["wd"], policy, counter, seed=7,
                 shard=row) + params["bd"]


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   device="cuda") -> torch.Tensor:
    return _init(gen, (vocab, d_model), scale=0.02, device=device)
