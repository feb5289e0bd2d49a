"""Model layers of the port (counterpart of the reference's
``models/layers.py``), as plain functions on tensors.

Params are nested dicts whose leaves carry the reference's names and
layouts.  Every step keeps the reference's dtype, so the CPU parity tests
hold at tight tolerances: matmuls and einsums run on bf16 operands and come
out in bf16, ``rope`` and the norms compute in f32 and cast back, softmax
runs in f32 and is cast back to bf16.  Prefill attention stays plain torch
ops, as the reference leaves it to XLA rather than a kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.numerics.policy import dense, matmul

Params = Dict[str, Any]

__all__ = ["rms_norm", "rope", "attention", "mlp", "softmax",
           "make_causal_mask", "init_attention", "init_mlp",
           "init_embedding"]


def _init(gen: torch.Generator, shape, scale=None, device="cuda"):
    """N(0, 1/fan_in) (or ``scale``) weights in bf16, drawn in f32 from
    ``gen`` on ``device``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * scale).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# norms & rotary
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


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
# attention (GQA, causal prefill)
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


def attention(params: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, window: int = 0, policy=None,
              counter=0, return_kv: bool = False):
    """Causal GQA self-attention over a full sequence (prefill).

    x: (B, S, d) bf16, positions: (B, S).  Returns ``(out, kv)``: ``kv`` is
    the post-RoPE ``(k, v)`` of this call's tokens, each
    (B, S, n_kv_heads, hd), when ``return_kv`` (the batched prefill
    scatters them into the ring cache), else None.  The score einsum comes
    out in bf16 before the f32 cast, as the reference's does.
    """
    b, s, _ = x.shape
    hd, nh, nkv = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
    q = dense(x, params["wq"], policy, counter, seed=1)
    k = dense(x, params["wk"], policy, counter, seed=2)
    v = dense(x, params["wv"], policy, counter, seed=3)
    if cfg.qkv_bias and "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = rope(q.reshape(b, s, nh, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, nkv, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, nkv, hd)
    kv_out = (k, v) if return_kv else None

    mask = make_causal_mask(s, s, window=window, device=x.device)
    group = nh // nkv
    qg = q.reshape(b, s, nkv, group, hd)
    # scores (B, nkv, group, S, S) and values as batched matmuls over
    # (B, nkv): f32 accumulation, rounded to bf16 as the reference's einsums
    qh = qg.permute(0, 2, 3, 1, 4).reshape(b, nkv, group * s, hd)
    kt = k.permute(0, 2, 3, 1)                              # (B, nkv, hd, S)
    logits = matmul(qh, kt).reshape(b, nkv, group, s, s).to(torch.float32)
    logits = logits / math.sqrt(hd)
    logits = torch.where(mask[None, None, None, :, :], logits, -1e30)
    probs = softmax(logits, dim=-1).to(x.dtype)
    vh = v.permute(0, 2, 1, 3)                              # (B, nkv, S, hd)
    out = matmul(probs.reshape(b, nkv, group * s, s), vh)
    out = out.reshape(b, nkv, group, s, hd).permute(0, 3, 1, 2, 4)
    out = out.reshape(b, s, nh * hd)
    return dense(out, params["wo"], policy, counter, seed=4), kv_out


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             act: str = "swiglu", device="cuda") -> Params:
    _check_act(act)
    return {"wg": _init(gen, (d_model, d_ff), device=device),
            "wu": _init(gen, (d_model, d_ff), device=device),
            "wd": _init(gen, (d_ff, d_model), device=device)}


def _check_act(act: str) -> None:
    if act != "swiglu":
        raise NotImplementedError(
            f"mlp_act={act!r} is not ported yet (the GELU archs belong to the "
            "rest of the zoo, ROADMAP Queue 1 item 11)")


def mlp(params: Params, x: torch.Tensor, act: str = "swiglu", policy=None,
        counter=0) -> torch.Tensor:
    """SwiGLU MLP: silu in f32, cast back, times the up projection."""
    _check_act(act)
    g = dense(x, params["wg"], policy, counter, seed=5)
    u = dense(x, params["wu"], policy, counter, seed=6)
    gf = g.to(torch.float32)
    h = (gf * torch.sigmoid(gf)).to(x.dtype) * u
    return dense(h, params["wd"], policy, counter, seed=7)


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   device="cuda") -> torch.Tensor:
    return _init(gen, (vocab, d_model), scale=0.02, device=device)
