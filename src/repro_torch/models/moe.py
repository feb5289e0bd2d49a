"""Mixture-of-Experts FFN (granite-3-moe, qwen2-moe): the port's
counterpart of the reference's ``models/moe.py``.

Dispatch is scatter-based, as there: top-k routing → per-expert capacity
slots from a cumulative count over the flattened (token, k) assignments →
scatter-add into an (E, C, d) buffer → batched expert SwiGLU products →
gather-combine.  Capacity C is static, so no shape depends on the data;
assignments past it drop (Switch-style), and which ones drop depends on
the top-k order and on every token of the call, padding included.

Serving under a mesh runs this on one data shard's rows, as the
reference's ``shard_map`` body does (its ``dp_shards()`` is 1 there), so
capacity ranks count the shard's local tokens and the experts need no
padding (``e_pad == e``).  On the training mesh (DESIGN.md §5) a rank
also runs its data shard's rows, so capacity is counted per data shard,
as the reference counts it on purpose; under TP the experts' FFN dim is
split (``wd``'s partial sums reduced over 'model') and the router stays
replicated.  The reference pads the expert axis to the TP size only to
lay out GSPMD's buffers; the port pads nothing, but under a policy it
hashes the dispatch buffer and the hidden activations at the padded
buffer's global index, ((s·e_pad + e)·cap + c)·d + j.  The expert
products are plain ``einsum``s, because the reference computes them
outside any kernel; under a policy their operands are fake-quantised
with the reference's seeds 11–15.  qwen2-moe's shared expert runs through
``layers.mlp``, so under a kernel-backend policy its products take the
dither-matmul kernel as every dense product does.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.dist import ctx
from repro_torch.dist.sharding import ShardView
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.numerics.policy import fake_quant, matmul

Params = Dict[str, Any]

__all__ = ["init_moe", "moe_ffn", "moe_capacity", "route"]


def _init(gen: torch.Generator, shape, scale=None, dtype=torch.bfloat16,
          device="cuda") -> torch.Tensor:
    """N(0, 1/fan_in) (fan_in = ``shape[-2]``) or ``scale``, drawn in f32
    from ``gen`` on ``device``, cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * scale).to(dtype)


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens:
    ⌈tokens · k · capacity_factor / E⌉, at least 1."""
    cap = int(math.ceil(n_tokens * cfg.n_experts_active
                        * cfg.capacity_factor / cfg.n_experts))
    return max(cap, 1)


def init_moe(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    """The reference's layout: an f32 router (d, E), stacked bf16 experts
    ``wg``/``wu`` (E, d, f) and ``wd`` (E, f, d), and a ``shared`` SwiGLU
    of width ``shared_d_ff`` where the config has one."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": _init(gen, (d, e), scale=0.02, dtype=torch.float32,
                         device=device),
         "wg": _init(gen, (e, d, f), device=device),
         "wu": _init(gen, (e, d, f), device=device),
         "wd": _init(gen, (e, f, d), device=device)}
    if cfg.shared_d_ff:
        sf = cfg.shared_d_ff
        p["shared"] = {"wg": _init(gen, (d, sf), device=device),
                       "wu": _init(gen, (d, sf), device=device),
                       "wd": _init(gen, (sf, d), device=device)}
    return p


def route(params: Params, cfg: ModelConfig, xf: torch.Tensor):
    """Routing of the flattened tokens xf (t, d), always in f32: softmax
    over the router logits, the top k in descending order, gates
    renormalised over k.  Then each assignment's capacity rank: a
    cumulative count per expert over the flattened (t, k) assignments in
    that order.  Returns (gate (t, k) f32, expert (t·k,) int64, slot
    (t·k,) int64 with dropped assignments at 0, valid (t·k,) bool)."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.n_experts_active
    cap = moe_capacity(t, cfg)
    logits = torch.matmul(xf.to(torch.float32), params["router"])
    probs = layers.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)                  # descending
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    expert = idx.reshape(t * k)
    oh = (expert[:, None] == torch.arange(e, device=xf.device)).to(
        torch.int32)                                          # (t·k, E)
    ranks = torch.cumsum(oh, dim=0) - 1
    slot = torch.sum(ranks * oh, dim=-1)                      # (t·k,)
    valid = slot < cap
    return gate, expert, torch.where(valid, slot, 0).long(), valid


def moe_ffn(params: Params, cfg: ModelConfig, x: torch.Tensor,
            policy=None, counter=0) -> torch.Tensor:
    """x (B, S, d) → (B, S, d).  Static capacity, drop on overflow.

    Every token of the call competes for capacity, padding and idle rows
    included, as in the reference: the caller's batch shape is part of
    the result."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.n_experts_active
    cap = moe_capacity(t, cfg)
    xf = x.reshape(t, d)
    gate, expert, slot, valid = route(params, cfg, xf)

    # dispatch: scatter-add into a zeroed (E, cap, d) buffer; a dropped
    # assignment adds zeros to slot 0, so the sums do not depend on the
    # order in which the scatter visits them
    token_ids = torch.arange(t, device=x.device)[:, None].expand(
        t, k).reshape(t * k)                                  # (t·k,)
    upd = xf[token_ids] * valid[:, None].to(x.dtype)
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((expert, slot), upd, accumulate=True)

    # expert SwiGLU: batched products over the expert axis (``matmul``:
    # f32 accumulation, bf16 out, as the reference's einsums)
    sh = ctx.train_shard()
    if sh is None:
        wg = fake_quant(params["wg"], policy, counter, seed=11)
        wu = fake_quant(params["wu"], policy, counter, seed=12)
        wd = fake_quant(params["wd"], policy, counter, seed=13)
        bufq = fake_quant(buf, policy, counter, seed=14)
        g = matmul(bufq, wg)
        u = matmul(bufq, wu)
        gf = g.to(torch.float32)
        h = (gf * torch.sigmoid(gf)).to(x.dtype) * u
        hq = fake_quant(h, policy, counter, seed=15)
        y = matmul(hq, wd)                                    # (E, cap, d)
    else:
        y = _experts_sharded(params, cfg, buf, policy, counter, sh)

    # combine: gather each assignment's row back, weight by gate · valid
    y_assign = y[expert, slot]                                # (t·k, d)
    w_assign = (gate.reshape(t * k) * valid)[:, None].to(x.dtype)
    out = torch.sum((y_assign * w_assign).reshape(t, k, d), dim=1)

    if "shared" in params:
        out = out + layers.mlp(params["shared"], xf, "swiglu", policy,
                               counter, d_ff=cfg.shared_d_ff)
    return out.reshape(b, s, d)


def _experts_sharded(params: Params, cfg: ModelConfig, buf: torch.Tensor,
                     policy, counter, sh) -> torch.Tensor:
    """The expert SwiGLU of one rank of the training mesh: ``buf`` (E, cap,
    d) is its data shard's dispatch buffer, ``wg``/``wu`` (E, d, f/tp) and
    ``wd`` (E, f/tp, d) its FFN blocks where the FFN dim is split.  Under
    a policy every operand is fake-quantised as its slice of the
    reference's global one: the weights over 'model', the buffer and the
    hidden activations at the padded (dp, e_pad, cap, ·) buffer's global
    indices.  Returns (E, cap, d), summed over 'model' where split."""
    e, cap, d = buf.shape
    f = cfg.d_ff
    f_l = params["wd"].shape[1]
    split = f_l != f
    f0 = sh.model * f_l if split else 0
    e_pad = -(-e // sh.tp) * sh.tp if sh.tp > 1 else e
    w_groups = sh.groups("model") if split else ()
    if split:
        buf = ctx.copy_to_model(buf)

    def quant(t, seed, view, groups):
        return fake_quant(t, policy, counter, seed=seed, view=view,
                          groups=groups)

    wview_up = ShardView((e, d, f), (0, 0, f0))
    wg = quant(params["wg"], 11, wview_up, w_groups)
    wu = quant(params["wu"], 12, wview_up, w_groups)
    wd = quant(params["wd"], 13, ShardView((e, f, d), (0, f0, 0)), w_groups)
    bufq = quant(buf[None], 14, ShardView((sh.dp, e_pad, cap, d),
                                          (sh.data, 0, 0, 0)),
                 sh.groups("data"))[0]
    g = matmul(bufq, wg)
    u = matmul(bufq, wu)
    gf = g.to(torch.float32)
    h = (gf * torch.sigmoid(gf)).to(buf.dtype) * u
    hq = quant(h[None], 15, ShardView((sh.dp, e_pad, cap, f),
                                      (sh.data, 0, 0, f0)),
               sh.groups("data", "model") if split else sh.groups("data"))[0]
    if not split:
        return matmul(hq, wd)
    return ctx.reduce_from_model(
        torch.matmul(hq.to(torch.float32), wd.to(torch.float32))
    ).to(buf.dtype)
