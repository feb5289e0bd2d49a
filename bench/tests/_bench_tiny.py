"""Tiny sizes of the benchmark's cells for the CPU tests: the cells'
own files with the model cut to a few hundred thousand weights and the
traffic to three clients of a few tokens each."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

DENSE = {"n_layers": 2, "d_model": 128, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 32, "d_ff": 256, "vocab_size": 512}
MOE = dict(DENSE, n_experts=8, n_experts_active=2)

# the tiny models' widest gap in logits: bf16 against float32 reads
# 0.01-0.03 on the dense cells and up to 0.3 where the tiny MoE's routing
# flips (test_bench_control.py); a fault reads more than 1
LIMIT = 0.5

CELLS = ("granite8b-dither-chat", "granitemoe-prefix-chat",
         "granite8b-int8kv-long", "granite8b-bf16-long")


def model(cell: str) -> dict:
    return MOE if "moe" in cell else DENSE


def traffic(cell: str) -> dict:
    t = {"engine": {"slots": 3, "max_len": 64, "decode_ticks": 2},
         "prompt": {"median": 8, "sigma": 0.5, "min": 4, "max": 20},
         "output": {"median": 4, "sigma": 0.5, "min": 2, "max": 8},
         "trace_seconds": 0.2}
    if "prefix" in cell:
        t["shared_prefix"] = {"count": 2, "tokens": 16, "zipf_s": 1.0}
    return t


def limits(cell: str) -> dict:
    """The tiny runs' limits: the widest gap within ``LIMIT``, whatever the
    cell compares, and where the cell holds the policy's products to the
    scheme, that exact comparison as the cell states it."""
    from bench import spec
    out = {"widest_gap": LIMIT}
    stated = spec.cell(cell)["check"]["limits"]
    if "product_mismatch" in stated:
        out["product_mismatch"] = stated["product_mismatch"]
    return out


def run_tiny(cell: str, seed: int = 11, seconds: float = 1.5, **kw):
    """One run of ``cell`` at the tiny sizes.  Its check samples some 40
    served tokens (the cells sample some 300 of longer requests) and
    holds them to ``limits(cell)``."""
    from bench import run
    check = dict({"tokens": 40, "limits": limits(cell)},
                 **kw.pop("check", {}))
    return run.run_cell(cell, seed, seconds, kw.pop("trace", False), "cpu",
                        model=model(cell), traffic=traffic(cell),
                        check=check, **kw)
