"""The plain float32 forward of the served decoders: pre-norm blocks of
grouped-query attention with rotary positions, then a SwiGLU MLP or a
top-k mixture of SwiGLU experts routed without capacity, then a final
RMSNorm and the LM head.

It reads the benchmark's weights (bf16 tensors in the layout the
benchmark makes, ``bench/weights.py``) and upcasts one layer at a time,
so a full-width model fits beside them.  TF32 is off while it runs.  It
processes one sequence at a time over all of its positions (teacher
forcing) and returns the logits of the positions asked for.

``control`` computes the same forward in a lower precision, for the
checks' controls: ``{"matmul": "fp8"}`` rounds both operands of every
product to float8 e4m3 (the router's float32 weight excepted: its input
is rounded), ``{"matmul": "dither", "bits": b}`` dither-rounds them onto
a b-bit grid, ``{"kv_bits": b}`` rounds keys and values per position and
head to b-bit codes (``rounding.py``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence

import torch

from bench.reference import rounding

__all__ = ["logits_at", "no_tf32"]


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class _Products:
    """Every product of the forward, in float32 or under the control's
    rounding of both operands (each product a seed of its own)."""

    def __init__(self, control: Optional[dict]):
        self.kind = (control or {}).get("matmul")
        self.bits = int((control or {}).get("bits", 8))
        self.n = 0

    def _round(self, t: torch.Tensor) -> torch.Tensor:
        self.n += 1
        if self.kind == "fp8":
            return rounding.fp8_round(t)
        if self.kind == "dither":
            return rounding.fake_quant(t, self.bits, "dither",
                                       seed=self.n)
        raise ValueError(f"unknown matmul control {self.kind!r}")

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.to(torch.float32)
        if self.kind is None:
            return x @ w
        return self._round(x) @ self._round(w)

    def act(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """A product whose weight keeps its stated float32 (the MoE
        router): only the activation takes the control's rounding."""
        w = w.to(torch.float32)
        return x @ w if self.kind is None else self._round(x) @ w


def _rms(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * gamma.to(torch.float32)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions on (S, H, hd), the halves rotated as a pair."""
    s, _, hd = x.shape
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _kv_control(t: torch.Tensor, bits: int, seed: int) -> torch.Tensor:
    s, nkv, hd = t.shape
    ctr = torch.arange(s, dtype=torch.int64, device=t.device)[:, None, None]
    idx = torch.arange(nkv * hd, dtype=torch.int64,
                       device=t.device).reshape(1, nkv, hd)
    codes, scale = rounding.kv_round(t, ctr, idx, seed, bits)
    return rounding.kv_dequant(codes, scale, bits)


def _attention(p: Dict, cfg: dict, h: torch.Tensor, mm: _Products,
               kv_bits: Optional[int]) -> torch.Tensor:
    s = h.shape[0]
    nh, nkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = _rope(mm(h, p["wq"]).reshape(s, nh, hd), cfg["rope_theta"])
    k = _rope(mm(h, p["wk"]).reshape(s, nkv, hd), cfg["rope_theta"])
    v = mm(h, p["wv"]).reshape(s, nkv, hd)
    if kv_bits:
        k, v = _kv_control(k, kv_bits, 101), _kv_control(v, kv_bits, 102)
    g = nh // nkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)
    return mm(out.reshape(s, nh * hd), p["wo"])


def _swiglu(wg, wu, wd, x: torch.Tensor, mm: _Products) -> torch.Tensor:
    return mm(torch.nn.functional.silu(mm(x, wg)) * mm(x, wu), wd)


def _moe(p: Dict, cfg: dict, x: torch.Tensor, mm: _Products) -> torch.Tensor:
    """Top-k routing of every token (softmax over the f32 router, the k
    largest gates renormalised) and the gate-weighted sum of its experts'
    SwiGLU outputs; no capacity, so nothing drops."""
    k = cfg["n_experts_active"]
    probs = torch.softmax(mm.act(x, p["router"]), -1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(cfg["n_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            y = _swiglu(p["wg"][e], p["wu"][e], p["wd"][e], x[rows], mm)
            out.index_add_(0, rows, y * gate[rows, slot, None])
    return out


def _layer(params: Dict, i: int) -> Dict:
    """Layer ``i``'s weights: the stacked leaves' row ``i``."""
    def row(tree):
        return {k: row(v) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return row(params["blocks"][0])


@torch.no_grad()
def logits_at(params: Dict, cfg: dict, tokens: Sequence[int],
              positions: Sequence[int],
              control: Optional[dict] = None) -> torch.Tensor:
    """float32 logits (len(positions), vocab_size) of the sequence
    ``tokens`` at ``positions``, each the prediction of the token after
    that position."""
    dev = params["embed"].device
    mm = _Products(control)
    kv_bits = (control or {}).get("kv_bits")
    with no_tf32():
        ids = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
        x = params["embed"][ids].to(torch.float32)
        eps = cfg["norm_eps"]
        for i in range(cfg["n_layers"]):
            p = _layer(params, i)
            x = x + _attention(p["attn"], cfg, _rms(x, p["ln1"], eps), mm,
                               kv_bits)
            h = _rms(x, p["ln2"], eps)
            if "moe" in p:
                x = x + _moe(p["moe"], cfg, h, mm)
            else:
                x = x + _swiglu(p["mlp"]["wg"], p["mlp"]["wu"],
                                p["mlp"]["wd"], h, mm)
        pos = torch.as_tensor(list(positions), dtype=torch.long, device=dev)
        h = _rms(x[pos], params["final_norm"], eps)
        head = params["embed"].T if cfg["tie_embeddings"] \
            else params["lm_head"]
        return mm(h, head)[:, : cfg["vocab_size"]]
