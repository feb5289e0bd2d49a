"""Random weights of a configuration, made on the device from the seed.

One ``torch.Generator`` on the device, seeded from ``--seed``, draws each
stacked leaf (all layers at once) in one call, in the type it is served
in (bf16; the MoE router float32, as the port keeps it).  The layout is
the one the port's engine takes: ``embed`` (V_pad, d), ``blocks`` = [one
dict whose leaves carry a leading layer axis], ``remainder`` = [],
``final_norm``, and ``lm_head`` (d, V_pad) unless the embeddings are
tied.  Scales: N(0, 1/fan_in) for projections and experts, 0.02 for the
embedding, the head and the router; norm gains 1 + N(0, 0.1²), so that a
forward that drops a gain differs from one that keeps it.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["make_params", "vocab_padded", "generator"]


def vocab_padded(cfg: dict) -> int:
    """The vocabulary padded to a multiple of 16, as the port lays out its
    embedding and head (pad rows are never looked up; the engine reads
    only the first ``vocab_size`` logits)."""
    return (cfg["vocab_size"] + 15) // 16 * 16


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _draw(g: torch.Generator, shape, scale: float, dtype, device):
    t = torch.randn(shape, generator=g, device=device, dtype=dtype)
    return t.mul_(scale)


def _gain(g: torch.Generator, shape, device):
    return _draw(g, shape, 0.1, torch.bfloat16, device).add_(1.0)


@torch.no_grad()
def make_params(cfg: dict, seed: int, device) -> Dict:
    g = generator(seed, device)
    bf = torch.bfloat16
    n, d, hd = cfg["n_layers"], cfg["d_model"], cfg["head_dim"]
    nh, nkv, f = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"]
    vp = vocab_padded(cfg)
    block = {
        "ln1": _gain(g, (n, d), device),
        "attn": {"wq": _draw(g, (n, d, nh * hd), d ** -0.5, bf, device),
                 "wk": _draw(g, (n, d, nkv * hd), d ** -0.5, bf, device),
                 "wv": _draw(g, (n, d, nkv * hd), d ** -0.5, bf, device),
                 "wo": _draw(g, (n, nh * hd, d), (nh * hd) ** -0.5, bf,
                             device)},
        "ln2": _gain(g, (n, d), device),
    }
    if cfg.get("n_experts"):
        e = cfg["n_experts"]
        block["moe"] = {
            "router": _draw(g, (n, d, e), 0.02, torch.float32, device),
            "wg": _draw(g, (n, e, d, f), d ** -0.5, bf, device),
            "wu": _draw(g, (n, e, d, f), d ** -0.5, bf, device),
            "wd": _draw(g, (n, e, f, d), f ** -0.5, bf, device)}
    else:
        block["mlp"] = {"wg": _draw(g, (n, d, f), d ** -0.5, bf, device),
                        "wu": _draw(g, (n, d, f), d ** -0.5, bf, device),
                        "wd": _draw(g, (n, f, d), f ** -0.5, bf, device)}
    params = {"embed": _draw(g, (vp, d), 0.02, bf, device),
              "blocks": [block], "remainder": [],
              "final_norm": _gain(g, (d,), device)}
    if not cfg["tie_embeddings"]:
        params["lm_head"] = _draw(g, (d, vp), 0.02, bf, device)
    return params
