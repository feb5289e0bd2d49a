"""The roofline and model-FLOP counts at shapes with known answers."""

import _bench_tiny  # noqa: F401  (paths)
import pytest

from bench import spec
from bench.context import Run
from bench.peaks import peaks

G8B = spec._json(spec.BENCH / "configs" / "granite_3_8b.json")["model"]
H100 = peaks("NVIDIA H100 80GB HBM3")


def _run(cfg, engine, requests, ticks=1, prefill_calls=0):
    return Run("t", cfg, {"engine": engine}, H100, {},
               {"seconds": 1.0, "busy_s": 1.0, "ticks": ticks,
                "stats": {"prefill_calls": prefill_calls},
                "op_seconds": {}, "requests": requests})


def test_one_mlp_product():
    """One granite-3-8b up projection for 32 decode rows, by hand: the
    weight's 4096 · 12800 bf16 elements read once, the rows' activations
    read and outputs written, 2 · 32 · 4096 · 12800 int8 operations and
    28 INT32 operations for each element rounded."""
    from bench.roofline import dither_matmul as dm
    k, n, m = 4096, 12800, 32
    t = dm._least(([(k, n)], (1, 1)), m, 0, 1, H100)
    bytes_ = 2 * (k * n + m * k + m * n) + 2 * 1
    ints = 28 * (k * n + m * k) + 28 * 1
    ops = 2 * m * k * n
    want = max(bytes_ / 3.35e12, ops / 1979e12,
               ints / (132 * 64 * 1.98e9))
    assert t == pytest.approx(want)
    # the rounding's INT32 work bounds it: ≈ 88 µs against 31 µs of bytes
    assert t == pytest.approx(ints / (132 * 64 * 1.98e9))
    assert 80e-6 < t < 95e-6


def test_dither_work_counts_rows_and_calls():
    from bench.roofline import dither_matmul as dm
    eng = {"policy": {"scheme": "dither"}}
    # one request of prompt 10 that decoded its tokens 1..4 in the slice
    run = _run(G8B, eng, [(10, 0, 1, 5)], ticks=4)
    one_tick = dm._least(dm._products(G8B), 1, 1, 1, H100)
    assert run.work("dither_matmul")["seconds"] == pytest.approx(
        4 * one_tick)
    assert _run(G8B, {"policy": None}, [(10, 0, 1, 5)]).work(
        "dither_matmul") is None


def test_attention_bytes_of_one_step():
    """Token 1 of a 100-token prompt attends 101 keys: bf16 keys and
    values of 8 heads of 128 in 40 layers, plus the query and output."""
    run = _run(G8B, {"kv_quant": False}, [(100, 0, 1, 2)])
    want = 40 * (101 * 2 * 8 * 128 * 2 + 2 * 2 * 32 * 128)
    assert run.work("attention")["bytes"] == want
    run8 = _run(G8B, {"kv_quant": True}, [(100, 0, 1, 2)])
    assert run8.work("attention")["bytes"] == \
        40 * (101 * 2 * 8 * (128 + 4) + 2 * 2 * 32 * 128)


def test_model_flops_of_a_decode_token():
    """2 FLOPs a weight of the layers and the head, 4 · heads · hd a layer
    for each key: granite-3-8b's ≈ 8.2 G weights."""
    run = _run(G8B, {}, [(100, 0, 1, 2)])
    d, f = 4096, 12800
    weights = 40 * (d * (32 + 16) * 128 + 32 * 128 * d + 3 * d * f) \
        + d * 49155
    want = 2 * weights + 4 * 32 * 128 * 40 * 101
    assert run.work("model")["flops"] == pytest.approx(want)
    assert 7.5e9 < weights < 8.5e9


def test_model_flops_of_a_prefill_after_a_prefix_hit():
    run = _run(G8B, {}, [(100, 64, 0, 1)])
    got = run.work("model")["flops"]
    base = _run(G8B, {}, [(100, 0, 0, 1)]).work("model")["flops"]
    assert got < base
    keys = sum(p + 1 for p in range(64, 100))
    per_key = 4 * 32 * 128 * 40
    body = run.work("model")["flops"] - per_key * keys
    assert body == pytest.approx(
        36 * (base - per_key * sum(p + 1 for p in range(100)) - 2 * 4096
              * 49155) / 100 + 2 * 4096 * 49155)


def test_kernel_maps_are_found_by_name():
    assert "gemm_u8" in spec.kernel_names("dither_matmul")
    assert "flash_decode_kernel" in spec.kernel_names("attention")
    run = _run(G8B, {}, [])
    run.slice["op_seconds"] = {"void flash_decode_kernel<128>": 0.5,
                               "merge_kernel": 0.25, "gemm_u8<bf16>": 2.0}
    assert run.kernel_seconds("attention") == pytest.approx(0.75)
    assert run.kernel_seconds("dither_matmul") == pytest.approx(2.0)


def test_unknown_card_has_no_peaks():
    assert peaks("NVIDIA A100-SXM4-80GB") is None
