"""The model FLOPs of everything the traced slice asked of the model:
2 per active weight for each token through the layers (attention
projections, the MLP or the k routed experts and the router), 4 · n_heads
· hd a layer for each key a token attends (scores and values), and the
LM head once per decode token and once per request prefilled (its last
position).  Padding rows, idle slots and recomputation are not counted.
"""

from __future__ import annotations

from bench.roofline import _slice


def _per_token(cfg: dict) -> float:
    d, hd, f = cfg["d_model"], cfg["head_dim"], cfg["d_ff"]
    nh, nkv = cfg["n_heads"], cfg["n_kv_heads"]
    attn = d * (nh + 2 * nkv) * hd + nh * hd * d
    if cfg.get("n_experts"):
        ffn = d * cfg["n_experts"] + cfg["n_experts_active"] * 3 * d * f
    else:
        ffn = 3 * d * f
    return 2.0 * cfg["n_layers"] * (attn + ffn)


def work(run):
    if run.slice is None or run.peaks is None:
        return None
    cfg = run.cfg
    body = _per_token(cfg)
    head = 2.0 * cfg["d_model"] * cfg["vocab_size"]
    per_key = 4.0 * cfg["n_heads"] * cfg["head_dim"] * cfg["n_layers"]
    flops = 0.0
    for keys in _slice.decode_keys(run):
        flops += body + head + per_key * keys
    for hit, length in _slice.prefills(run):
        n = length - hit
        # position p attends p + 1 keys: the sum over hit … length − 1
        keys = (hit + 1 + length) * n / 2.0
        flops += body * n + head + per_key * keys
    return {"flops": flops, "seconds": flops / run.peaks["bf16_flops"]}
