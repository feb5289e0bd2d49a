"""The port's model layers, KV quantiser, batched prefill and decode step
against the reference's, on the same weights (``interop.params_from_numpy``)
at ``smollm_135m.reduced()``.

Tolerances, each for its reason:

* bf16 outputs of single ops (``rms_norm``, ``rope``, ``mlp``, prefill
  ``attention``) are held to one bf16 ulp: on the CPU both sides compute
  in f32 and round once, and differ at most in f32 rounding before that.
* ``rope`` on f32 inputs: 1e-6 absolute (cos/sin of angles up to 16 rad
  differ by an f32 ulp between the two libraries).
* The int8 KV quantiser is **bitwise** for the same K/V input, codes and
  scales.
* The first layer's prefill cache is bitwise in bf16 and int8 here (layer
  0 sees only the embedding); the bound held is one bf16 ulp, ``|Δcode| ≤
  1`` and scales within one bf16 ulp, since a K/V ulp may move a code.
* Logits (bf16 values cast to f32) within ``LOGIT_TOL`` = 2**-6: the
  reference's jit keeps excess f32 precision through some bf16
  intermediates and sums in another order, so a logit may move by up to
  2 bf16 ulps at |logit| < 2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config
from repro_torch.interop import cache_from_numpy, params_from_numpy
from repro_torch.models import layers, registry, transformer

CFG = ref_get_config("smollm_135m").reduced()
PCFG = get_config("smollm_135m").reduced()
PARAMS = ref_registry.init_model(jax.random.PRNGKey(0), CFG)
NP_PARAMS = jax.tree.map(np.asarray, PARAMS)
TORCH_PARAMS = params_from_numpy(NP_PARAMS, "cpu")
LOGIT_TOL = 2.0 ** -6


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_bf16_ulps(got, want, n=1):
    """|got - want| ≤ n bf16 ulps of the larger magnitude."""
    got, want = _f32(got).astype(np.float64), _f32(want).astype(np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= n * ulp), np.abs(got - want).max()


def _bf16(rng, shape, scale=1.0):
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


@pytest.mark.parametrize("arch", ["smollm_135m", "qwen2_1_5b"])
def test_configs_are_the_reference_configs(arch):
    ref = ref_get_config(arch)
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref)
    port = get_config(arch.replace("_", "-")).reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref.reduced())
    assert get_config(arch).vocab_padded() == ref.vocab_padded()


def test_params_carry_over_bitwise():
    """bf16 leaves cross through numpy bit for bit, stacked (R, …) axis
    included."""
    wq_ref = NP_PARAMS["blocks"][0]["attn"]["wq"]
    wq = TORCH_PARAMS["blocks"][0]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and tuple(wq.shape) == wq_ref.shape
    assert np.array_equal(wq.view(torch.int16).numpy(),
                          wq_ref.view(np.int16))


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    jx, tx = _bf16(rng, (2, 12, 128))
    _assert_bf16_ulps(layers.rms_norm(tx, TORCH_PARAMS["final_norm"]),
                      ref_layers.rms_norm(jx, PARAMS["final_norm"]))
    pos = np.tile(np.arange(0, 24, 2), (2, 1)).astype(np.int32)
    xr = rng.normal(size=(2, 12, 4, 32)).astype(np.float32)
    for theta in (1e4, 1e6):
        want = ref_layers.rope(jnp.asarray(xr), jnp.asarray(pos), theta)
        got = layers.rope(torch.from_numpy(xr), torch.from_numpy(pos), theta)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-6, rtol=0)
        _assert_bf16_ulps(
            layers.rope(torch.from_numpy(xr).bfloat16(),
                        torch.from_numpy(pos), theta),
            ref_layers.rope(jnp.asarray(xr, jnp.bfloat16), jnp.asarray(pos),
                            theta))


@pytest.mark.parametrize("layer", [0, 1])
def test_mlp_and_prefill_attention(layer):
    rng = np.random.default_rng(layer)
    jx, tx = _bf16(rng, (2, 12, 128))
    jb = jax.tree.map(lambda t: t[layer], PARAMS["blocks"][0])
    tb = transformer._index(TORCH_PARAMS["blocks"][0], layer)
    _assert_bf16_ulps(layers.mlp(tb["mlp"], tx), ref_layers.mlp(jb["mlp"], jx))
    pos = np.tile(np.arange(12), (2, 1)).astype(np.int32)
    jo, (jk, jv) = ref_layers.attention(jb["attn"], CFG, jx, jnp.asarray(pos),
                                        return_kv=True)
    to, (tk, tv) = layers.attention(tb["attn"], PCFG, tx,
                                    torch.from_numpy(pos), return_kv=True)
    for got, want in ((to, jo), (tk, jk), (tv, jv)):
        _assert_bf16_ulps(got, want)


def test_kv_q8_bitwise():
    """Same K/V in, same int8 codes and f32 scales out."""
    rng = np.random.default_rng(0)
    jk, tk = _bf16(rng, (4, 64, 3, 64), scale=3.0)
    ctr = rng.integers(-5, 5000, size=(4, 64, 1, 1)).astype(np.int32)
    for seed in (101, 102):
        jq, js = ref_tf._kv_q8(jk, jnp.asarray(ctr), ref_tf._kv_elem_idx(3, 64),
                               seed)
        tq, ts = transformer._kv_q8(tk, torch.from_numpy(ctr),
                                    transformer._kv_elem_idx(3, 64, "cpu"),
                                    seed)
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert np.array_equal(ts.numpy().view(np.uint32),
                              np.asarray(js).view(np.uint32))


def _prefill_inputs(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, CFG.vocab_size, size=(3, 16)).astype(np.int32)
    lens = np.array([16, 9, 5], np.int32)
    off = np.array([0, 1000, 2000], np.int32)
    return toks, lens, off


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_cache_first_layer(kv_quant):
    toks, lens, off = _prefill_inputs(0)
    max_len = 12          # below the longest prompt: the ring wraps
    jl, jc = ref_tf.prefill_with_cache(
        PARAMS, CFG, jnp.asarray(toks), jnp.asarray(lens), max_len,
        kv_quant=kv_quant, kv_offset=jnp.asarray(off))
    tl, tc = transformer.prefill_with_cache(
        TORCH_PARAMS, PCFG, torch.from_numpy(toks).long(),
        torch.from_numpy(lens), max_len, kv_quant=kv_quant,
        kv_offset=torch.from_numpy(off))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    assert np.array_equal(tc["pos"].numpy(), lens)
    want = jax.tree.map(lambda t: np.asarray(t[0]), jc["layers"][0])
    got = {k: v[0] for k, v in tc["layers"][0].items()}
    assert sorted(got) == sorted(want)
    assert np.array_equal(got["k_pos"].numpy(), want["k_pos"])
    if kv_quant:
        for name in ("k", "v"):
            d = np.abs(got[name].numpy().astype(int) - want[name].astype(int))
            assert d.max() <= 1
        for name in ("k_scale", "v_scale"):
            _assert_bf16_ulps(got[name], want[name])
    else:
        for name in ("k", "v"):
            _assert_bf16_ulps(got[name], want[name])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_logits(kv_quant):
    """Three decode steps after a batched prefill, each side from its own
    prefill, teacher-forced with the reference's greedy tokens."""
    toks, lens, off = _prefill_inputs(1)
    max_len = 32
    jl, jc = ref_registry.apply_prefill(
        PARAMS, CFG, jnp.asarray(toks), jnp.asarray(lens), max_len,
        kv_quant=kv_quant, kv_offset=jnp.asarray(off))
    tl, tc = registry.apply_prefill(
        TORCH_PARAMS, PCFG, torch.from_numpy(toks).long(),
        torch.from_numpy(lens), max_len, kv_quant=kv_quant,
        kv_offset=torch.from_numpy(off))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for _ in range(3):
        jl, jc = ref_registry.apply_decode(PARAMS, CFG, jnp.asarray(cur), jc,
                                           kv_offset=jnp.asarray(off))
        tl, tc = registry.apply_decode(TORCH_PARAMS, PCFG,
                                       torch.from_numpy(cur), tc,
                                       kv_offset=torch.from_numpy(off))
        assert tl.shape == (3, CFG.vocab_size) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
        cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
    assert np.array_equal(tc["pos"].numpy(), lens + 3)


def test_decode_from_reference_cache():
    """The port decodes from a reference ring cache carried over with
    ``interop.cache_from_numpy``, int8 codes and all."""
    toks, lens, off = _prefill_inputs(2)
    _, jc = ref_tf.prefill_with_cache(PARAMS, CFG, jnp.asarray(toks),
                                      jnp.asarray(lens), 32, kv_quant=True)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    cur = np.array([3, 4, 5], np.int32)
    jl, _ = ref_tf.decode_step(PARAMS, CFG, jnp.asarray(cur), jc)
    tl, _ = transformer.decode_step(TORCH_PARAMS, PCFG, torch.from_numpy(cur),
                                    tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)


def test_out_of_slice_knobs_raise():
    """Paged caches, quantised-matmul policies and other families raise
    NotImplementedError naming their ROADMAP item."""
    from repro_torch.numerics.policy import dense
    from repro_torch.serve import Engine

    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        transformer.init_cache(PCFG, 2, 8, kv_layout="paged", device="cpu")

    class _Policy:
        enabled = True

    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        dense(torch.zeros(2, 4), torch.zeros(4, 4), _Policy())
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        registry.init_model(dataclasses.replace(PCFG, family="ssm"),
                            device="cpu")
    for knob, item in [("decode_ticks", 6), ("mesh", 10), ("metrics", 8),
                       ("spec_decode", 7), ("prefill_chunk", 6)]:
        value = {"decode_ticks": 4, "spec_decode": True,
                 "prefill_chunk": 8}.get(knob, "x")
        with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
            Engine(TORCH_PARAMS, PCFG, 2, 16, device="cpu", **{knob: value})
