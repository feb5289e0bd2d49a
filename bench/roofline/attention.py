"""The work of decode attention over the traced slice: every decode step
reads its request's keys and values once, at the positions it attends
(L + j keys for token j of a prompt of L), in every attention layer, and
its query, and writes its output.

Bytes a key in a layer: keys and values, n_kv · hd elements each, at 2
bytes (bf16) or 1 (int8 codes) plus one float32 scale a head for each
(the int8 cache).  The query and the output, n_heads · hd elements, at 2
bytes each.  Attention reads far more than it computes, so the least
time is the bytes over the HBM's peak.  Prefill attention runs outside
these kernels and is not counted.
"""

from __future__ import annotations

from bench.roofline import _slice


def work(run):
    if run.slice is None or run.peaks is None:
        return None
    cfg = run.cfg
    nkv, hd, nh = cfg["n_kv_heads"], cfg["head_dim"], cfg["n_heads"]
    int8 = bool(run.traffic["engine"].get("kv_quant"))
    per_key = 2 * nkv * (hd * (1 if int8 else 2) + (4 if int8 else 0))
    per_step = 2 * 2 * nh * hd
    keys, steps = 0, 0
    for k in _slice.decode_keys(run):
        keys += k
        steps += 1
    if not steps:
        return None
    bytes_ = cfg["n_layers"] * (keys * per_key + steps * per_step)
    return {"seconds": bytes_ / run.peaks["hbm_bytes"], "bytes": bytes_}
