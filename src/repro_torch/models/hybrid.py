"""RecurrentGemma's RG-LRU recurrent block (arXiv:2402.19427) in the port
(counterpart of the reference's ``models/hybrid.py``).

The block has two branches, (linear → causal conv → RG-LRU) ⊙ (linear →
GELU), then an output projection.  The gates are block-diagonal over
heads.  The linear recurrence h_t = a_t ⊙ h_{t−1} + √(1−a_t²)·(i_t ⊙ x_t)
runs as a log-depth (Hillis–Steele) scan of torch ops over the sequence
for training, where the reference runs ``associative_scan`` (another
summation order: the two agree to f32 rounding), and as an O(1) state
update for decode.  ``rglru_decode_step`` returns the new state as new
tensors; the decode step of ``models/transformer.py`` writes it into the
cache in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import gelu
from repro_torch.models.ssm import causal_conv
from repro_torch.numerics.policy import dense

Params = Dict[str, Any]

__all__ = ["init_rglru", "init_rglru_state", "rglru_block",
           "rglru_decode_step", "linear_scan"]

_C = 8.0  # the RG-LRU temperature constant


def _init(gen: torch.Generator, shape, scale=None, device="cuda"):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * scale).to(torch.bfloat16)


def _n_blocks(cfg: ModelConfig) -> int:
    return max(1, cfg.n_heads)


def init_rglru(gen: torch.Generator, cfg: ModelConfig,
               device="cuda") -> Params:
    """The reference's RG-LRU parameters (lru width = d_model): the two
    input projections, the conv, the block-diagonal recurrence and input
    gates, Λ and the output projection."""
    d = cfg.d_model
    nb = _n_blocks(cfg)
    bd = d // nb
    return {
        "in_x": _init(gen, (d, d), device=device),
        "in_gate": _init(gen, (d, d), device=device),
        "conv_w": _init(gen, (cfg.rglru_conv_width, d), scale=0.5,
                        device=device),
        "gate_a": _init(gen, (nb, bd, bd), device=device),
        "gate_x": _init(gen, (nb, bd, bd), device=device),
        "lam": torch.linspace(0.9, 0.999, d, dtype=torch.float32,
                              device=device),
        "out": _init(gen, (d, d), device=device),
    }


def init_rglru_state(cfg: ModelConfig, batch: int, device="cuda") -> Params:
    """Zero decode state: ``h`` f32 (B, lru), ``conv`` bf16 (B, W−1, lru)."""
    d = cfg.d_model
    return {"h": torch.zeros((batch, d), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.rglru_conv_width - 1, d),
                                dtype=torch.bfloat16, device=device)}


def _gates(params: Params, xb: torch.Tensor, nb: int, bd: int):
    """Block-diagonal sigmoid gates in f32, xb (..., lru) → r, i."""
    lead = xb.shape[:-1]
    xg = xb.reshape(*lead, nb, bd).to(torch.float32)
    r = torch.sigmoid(torch.einsum("...nb,nbc->...nc", xg,
                                   params["gate_a"].to(torch.float32)))
    i = torch.sigmoid(torch.einsum("...nb,nbc->...nc", xg,
                                   params["gate_x"].to(torch.float32)))
    return r.reshape(*lead, nb * bd), i.reshape(*lead, nb * bd)


def _coefficients(params: Params, xc: torch.Tensor, nb: int, bd: int):
    """(a, b) of h = a ⊙ h_prev + b for the conv outputs xc (..., lru)."""
    r, i = _gates(params, xc, nb, bd)
    log_a0 = torch.log(torch.sigmoid(params["lam"]))   # per-channel, < 0
    log_a = _C * r * log_a0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) * (
        i * xc.to(torch.float32))
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1):
    """h_t = a_t h_{t−1} + b_t from h_{−1} = 0 along ``dim``, in
    ⌈log2 L⌉ Hillis–Steele rounds: round k combines each position with
    the one 2^k before it, (a1, b1) then (a2, b2) → (a1 a2, a2 b1 + b2),
    the reference's ``associative_scan`` operator."""
    a, b = a.movedim(dim, 0), b.movedim(dim, 0)
    length, off = a.shape[0], 1
    while off < length:
        a_prev, b_prev = a[:-off], b[:-off]
        a_cur, b_cur = a[off:], b[off:]
        a = torch.cat([a[:off], a_prev * a_cur])
        b = torch.cat([b[:off], a_cur * b_prev + b_cur])
        off *= 2
    return b.movedim(0, dim)


def rglru_block(params: Params, cfg: ModelConfig, u: torch.Tensor,
                policy=None, counter=0) -> torch.Tensor:
    """Full-sequence RG-LRU block, u (B, L, d) → (B, L, d)."""
    nb = _n_blocks(cfg)
    bd = cfg.d_model // nb
    x = dense(u, params["in_x"], policy, counter, seed=31)
    gate = dense(u, params["in_gate"], policy, counter, seed=32)
    x = causal_conv(x, params["conv_w"])
    a, b = _coefficients(params, x, nb, bd)
    h = linear_scan(a, b, dim=1)
    y = h.to(u.dtype) * gelu(gate)
    return dense(y, params["out"], policy, counter, seed=33)


def rglru_decode_step(params: Params, cfg: ModelConfig, u: torch.Tensor,
                      state: Params, policy=None, counter=0):
    """Single-token decode, u (B, 1, d) → ((B, 1, d), new state ``{"h",
    "conv"}``, as new tensors).

    On the training mesh the block's params and the conv state stay
    replicated (the reference has no rule for them); where
    ``dist.sharding.cache_specs`` cuts ``h`` by width, the rank updates
    its block (B, lru / tp) from the replicated gates (the recurrence is
    diagonal) and runs ``out`` row-parallel on that block (the rows of
    the replicated weight), the partials summed over 'model' in
    ``dense``: the reference's GSPMD decode partitions it so.  Gathering
    ``h`` for a whole ``out`` instead left the reduced recurrentgemma's
    logits 8.7e-3 from the reference's sharded ones, where this form
    gives them bit for bit (``tests/test_torch_decode_mesh.py``)."""
    nb = _n_blocks(cfg)
    bd = cfg.d_model // nb
    x = dense(u, params["in_x"], policy, counter, seed=31)
    gate = dense(u, params["in_gate"], policy, counter, seed=32)
    xc = causal_conv(x, params["conv_w"], carry=state["conv"])[:, 0]
    new_conv = torch.cat([state["conv"], x.to(state["conv"].dtype)],
                         dim=1)[:, 1:]
    a, b = _coefficients(params, xc, nb, bd)
    width = state["h"].shape[-1]          # lru, or this rank's block
    sh = layers.tp_shard() if width != cfg.d_model else None
    w0 = 0 if sh is None else sh.model * width
    blk = slice(w0, w0 + width)
    h = state["h"] * a[:, blk] + b[:, blk]
    y = h[:, None, :].to(u.dtype) * gelu(gate[..., blk])
    w = params["out"][blk]
    row = None if sh is None else layers.row_shard(y, w, sh)
    return dense(y, w, policy, counter, seed=33, shard=row), {
        "h": h, "conv": new_conv}
