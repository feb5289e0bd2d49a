"""The plain reference against the port at a tiny size on the CPU: its
float32 forward equals the port's forward run in float32 (dense and
MoE), and its frozen roundings and dither product are the port's at 8
bits, bit for bit."""

import _bench_tiny
import pytest
import torch

from bench import program, spec, weights
from bench.reference import model as ref
from bench.reference import dither_product, rounding

CONFIGS = {"granite_3_8b": _bench_tiny.DENSE,
           "granite_moe_1b_a400m": _bench_tiny.MOE}


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_is_the_ports_in_float32(name):
    from repro_torch.models import transformer
    conf = spec._json(spec.BENCH / "configs" / f"{name}.json")
    over = CONFIGS[name]
    cfg = dict(conf["model"], **over)
    params = weights.make_params(cfg, 5, "cpu")
    toks = torch.randint(1, over["vocab_size"], (1, 40),
                         generator=torch.Generator().manual_seed(3))
    got = transformer.forward(_f32(params), program.model_config(
        conf, override=over), toks, remat=False)[0, :, :cfg["vocab_size"]]
    want = ref.logits_at(params, cfg, toks[0].tolist(), range(40))
    # the same float32 arithmetic in another order: a few ulps of logits
    # of magnitude ≈ 1
    assert (got - want).abs().max().item() < 1e-5


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_at_picks_positions(name):
    conf = spec._json(spec.BENCH / "configs" / f"{name}.json")
    cfg = dict(conf["model"], **CONFIGS[name])
    params = weights.make_params(cfg, 1, "cpu")
    toks = list(range(1, 21))
    full = ref.logits_at(params, cfg, toks, range(20))
    part = ref.logits_at(params, cfg, toks, [4, 19])
    assert torch.equal(part, full[[4, 19]])


def test_kv_rounding_is_the_int8_cache():
    from repro_torch.models.transformer import _kv_elem_idx, _kv_q8
    g = torch.Generator().manual_seed(0)
    t = torch.randn(3, 5, 2, 32, generator=g).to(torch.bfloat16)
    ctr = torch.arange(15, dtype=torch.int64).reshape(3, 5, 1, 1) + 1000
    idx = _kv_elem_idx(2, 32, "cpu")
    codes, scale = _kv_q8(t, ctr, idx, 101)
    mine, mscale = rounding.kv_round(t, ctr, idx, 101, bits=8)
    assert torch.equal(codes.float(), mine)
    assert torch.equal(scale, mscale)


@pytest.mark.parametrize("scheme", ["dither", "deterministic"])
def test_fake_quant_is_the_policys(scheme):
    from repro_torch.numerics.policy import QuantPolicy, _fake_quant
    g = torch.Generator().manual_seed(1)
    x = torch.randn(6, 40, generator=g)
    pol = QuantPolicy(scheme=scheme, bits=8)
    want = _fake_quant(x, pol, 7.0, 3)
    got = rounding.fake_quant(x, 8, scheme, counter=7.0, seed=3)
    assert torch.equal(want, got)


def test_lower_precisions_are_coarser():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(64, 64, generator=g)
    e8 = (rounding.fake_quant(x, 8) - x).abs().mean()
    e4 = (rounding.fake_quant(x, 4) - x).abs().mean()
    efp8 = (rounding.fp8_round(x) - x).abs().mean()
    ebf = (x.to(torch.bfloat16).float() - x).abs().mean()
    assert e4 > 8 * e8 and efp8 > 4 * ebf
    ctr = torch.zeros(64, 1, dtype=torch.int64)
    idx = torch.arange(64, dtype=torch.int64)[None, :]
    c4, s4 = rounding.kv_round(x, ctr, idx, 101, bits=4)
    assert c4.abs().max() <= 8
    k4 = (rounding.kv_dequant(c4, s4, 4) - x).abs().mean()
    c8, s8 = rounding.kv_round(x, ctr, idx, 101, bits=8)
    k8 = (rounding.kv_dequant(c8, s8, 8) - x).abs().mean()
    assert k4 > 8 * k8


def test_no_tf32_restores():
    before = torch.backends.cuda.matmul.allow_tf32
    with ref.no_tf32():
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before


@pytest.mark.parametrize("m,k,n,counter,seed", [
    (8, 128, 96, 0, 5), (32, 64, 200, 1234, 1), (150, 96, 40, 7, 9)])
def test_dither_product_is_the_policys(m, k, n, counter, seed):
    """The frozen product equals the port's plain policy product (the
    CUDA kernel's plain version) bit for bit, whole and on chosen rows."""
    from repro_torch.kernels.ref import dither_matmul_scaled_ref
    g = torch.Generator().manual_seed(m + n)
    x = (torch.randn(m, k, generator=g) * 3).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g) / 8).to(torch.bfloat16)
    want = dither_matmul_scaled_ref(x, w, bits=8, counter=counter,
                                    seed=seed)
    got = dither_product.product(x, w, bits=8, seed=seed, counter=counter)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    rows = torch.tensor([0, m // 2, m - 1])
    part = dither_product.product(x, w, bits=8, seed=seed, counter=counter,
                                  rows=rows)
    assert torch.equal(part.view(torch.int16), want[rows].view(torch.int16))
    four = dither_product.product(x, w, bits=4, seed=seed, counter=counter)
    assert (four != want).float().mean() > 0.9
