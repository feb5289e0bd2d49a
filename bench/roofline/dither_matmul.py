"""The work of the paper's §VIII product (the dither matmul policy) over
the traced slice, counted from the model's shapes and what the slice
asked of it, never from the kernel that does it.

For every dense product x (M, K) @ w (K, N) of a call, the scheme needs:

* bytes: w read once (bf16, 2 B an element), since a call rounds the
  weight afresh (the rounding's counter is the call's tick); x read once
  and the output written once (bf16);
* int8 tensor operations: 2·M·K·N (a multiply and an add per
  multiply-accumulate of the two grids' codes);
* INT32 operations on the CUDA cores: 28 for each element rounded, w's
  K·N and x's M·K.  Dither rounding hashes every element twice: the
  uniform (the index multiply, two xors and two murmur finalisers of 8
  operations each: 3 shift-xors and 2 multiplies) and the pulse slot's
  phase (one finaliser and two xors).  The slot's modulo, the compare
  and the code's arithmetic are not counted, so the count is a floor.

M counts only the rows the slice needed: one per decode token and per
prompt token prefilled, and at the LM head one per decode token and per
request prefilled.  Calls are the slice's decode ticks and prefill calls.
The least time of a group of like calls (the decode ticks; the prefill
calls) is the largest of its bytes, its int8 and its INT32 operations
over their peaks; the work's least time is the two groups' sum.  MoE
experts are not counted: the policy fake-quantises them with torch
operations outside this product.
"""

from __future__ import annotations

from bench.roofline import _slice

ROUNDING_OPS = 28


def _products(cfg: dict):
    d, hd, f = cfg["d_model"], cfg["head_dim"], cfg["d_ff"]
    nh, nkv = cfg["n_heads"], cfg["n_kv_heads"]
    per_layer = [(d, nh * hd), (d, nkv * hd), (d, nkv * hd), (nh * hd, d)]
    if not cfg.get("n_experts"):
        per_layer += [(d, f), (d, f), (f, d)]
    return per_layer * cfg["n_layers"], (d, cfg["vocab_size"])


def _least(shapes, rows, head_rows, calls, peaks) -> float:
    if calls == 0:
        return 0.0
    bytes_ = ops = int_ops = 0.0
    body, head = shapes
    for (k, n), m in [(s, rows) for s in body] + [(head, head_rows)]:
        bytes_ += 2.0 * (calls * k * n + m * k + m * n)
        ops += 2.0 * m * k * n
        int_ops += ROUNDING_OPS * (calls * k * n + m * k)
    return max(bytes_ / peaks["hbm_bytes"], ops / peaks["int8_ops"],
               int_ops / peaks["int32_ops"])


def work(run):
    if run.slice is None or run.peaks is None \
            or not run.traffic["engine"].get("policy"):
        return None
    shapes = _products(run.cfg)
    decode_rows = sum(1 for _ in _slice.decode_keys(run))
    pf = list(_slice.prefills(run))
    prefill_rows = sum(length - hit for hit, length in pf)
    seconds = _least(shapes, decode_rows, decode_rows, run.slice["ticks"],
                     run.peaks) \
        + _least(shapes, prefill_rows, len(pf),
                 run.slice["stats"]["prefill_calls"], run.peaks)
    return {"seconds": seconds}
