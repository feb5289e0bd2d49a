"""The attention-only rest of the zoo in the port — granite-3-8b,
minicpm-2b, internvl2-1b (its stub frontend's ``embeds``), granite-moe-
1b-a400m and qwen2-moe-a2.7b — against the reference at ``.reduced()``,
on the same weights (``interop.params_from_numpy``): the full-sequence
forward, the batched ring prefill and decode steps (bf16 and int8 KV),
and the paged prefill and decode steps.

Tolerances, each for its reason (as in ``tests/test_torch_model.py``):

* Logits within ``LOGIT_TOL`` = 2⁻⁶: the reference's jit keeps excess
  f32 precision through some bf16 intermediates and sums in another
  order, so a logit may move by a few bf16 ulps.
* The reference is compiled as written (``tests/_torch_zoo.py``,
  ``EXACT``): with XLA's excess precision its MoE router sees unrounded
  activations and a near-tied top-k picks another expert, which moves a
  token's logits by up to 0.27.  Compiled so, it routes as the port
  does.
* The ring cache's positions are exact; the paged pool is held through
  the logits of the decode steps that read it.

The weights are the port's init carried to the reference
(``tests/_torch_zoo.py``); the QKV biases of internvl2 and qwen2-moe are
drawn at random.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from _torch_zoo import ZOO, embeds, model, ref_jit
from repro.configs import get_config as ref_get_config
from repro.models import registry as ref_registry
from repro.models import transformer as ref_tf
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.interop import cache_from_numpy, params_from_numpy
from repro_torch.models import registry, transformer

LOGIT_TOL = 2.0 ** -6
BS, MAX_LEN, NUM_BLOCKS = 4, 32, 20
REF_FORWARD = ref_jit(ref_registry.apply_model, static_argnames=("remat",))
REF_PREFILL = ref_jit(ref_registry.apply_prefill, static_argnums=(1, 4),
                      static_argnames=("kv_quant",))
REF_PREFILL_PAGED = ref_jit(ref_tf.prefill_with_cache_paged,
                            static_argnames=("kv_quant",))
REF_DECODE = ref_jit(ref_registry.apply_decode)
REF_DECODE_PAGED = ref_jit(ref_tf.decode_step)


@pytest.mark.parametrize("arch", ZOO)
def test_configs_are_the_reference_configs(arch):
    ref = ref_get_config(arch)
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref)
    port = get_config(arch.replace("_", "-")).reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref.reduced())


def test_arch_ids_follow_the_reference_and_the_rest_raise():
    """The port has the reference's ten archs in its order, the
    encoder-decoder (item 11b-ii) last, under either id form; an arch the
    reference lacks raises."""
    from repro.configs import ARCH_IDS as REF_IDS

    assert ARCH_IDS == REF_IDS
    assert set(ZOO) <= set(ARCH_IDS)
    for arch in ("whisper_small", "whisper-small"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            ref_get_config("whisper_small"))
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("whisper_large")


def test_param_trees_cross_bitwise():
    """The MoE tree (f32 router, stacked (R, E, d, f) experts, the shared
    expert), the VLM tree and the encoder-decoder's (stacked encoder and
    decoder blocks, ``{g, b}`` norms, ``enc_pos``): the port's init has
    the reference's init's tree (key paths in JAX's flatten order, shapes,
    dtypes), and the leaves cross to the reference and back
    (``interop.params_from_numpy``) bit for bit."""
    for arch in ("qwen2_moe_a2_7b", "internvl2_1b", "whisper_small"):
        cfg, pcfg, params, tp = model(arch)
        ref = jax.eval_shape(lambda: ref_registry.init_model(
            jax.random.PRNGKey(0), cfg))
        flat, _ = jax.tree_util.tree_flatten_with_path(ref)
        ours = tree.leaves_with_path(tp)
        assert ["/".join(str(k) for k in p) for p, _ in flat] == [
            tree.path_str(p) for p, _ in ours]
        for (_, want), (_, got) in zip(flat, ours):
            assert tuple(got.shape) == want.shape
            assert str(got.dtype).split(".")[-1] == want.dtype.name
        back = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
        for got, want in zip(tree.leaves(back), tree.leaves(tp)):
            assert got.dtype == want.dtype
            assert torch.equal(got.view(torch.int16) if got.dtype ==
                               torch.bfloat16 else got,
                               want.view(torch.int16) if want.dtype ==
                               torch.bfloat16 else want)
    moe = model("qwen2_moe_a2_7b")[3]["blocks"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert tuple(moe["wg"].shape) == (2, 8, 128, 256)
    assert sorted(moe["shared"]) == ["wd", "wg", "wu"]


@pytest.mark.parametrize("arch", ZOO)
def test_forward_logits_match_reference(arch):
    """``registry.apply_model`` against the reference's: full-sequence f32
    logits over the padded vocab, internvl2 with 16 stub embeds
    prepended (positions then run over F + S)."""
    cfg, pcfg, params, tp = model(arch)
    toks = np.random.default_rng(1).integers(
        1, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    je, te = embeds(cfg, 2)
    want = REF_FORWARD(params, cfg, {"tokens": jnp.asarray(toks),
                                     "embeds": je}, remat=False)
    got = registry.apply_model(tp, pcfg, {"tokens": torch.from_numpy(toks),
                                          "embeds": te}, remat=False)
    assert tuple(got.shape) == want.shape == (
        2, 12 + cfg.n_frontend_tokens, cfg.vocab_padded())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)


def _prompts(cfg, seed, lens, width=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(len(lens), width))
    lens = np.asarray(lens, np.int32)
    toks = np.where(np.arange(width)[None, :] < lens[:, None], toks, 0)
    return toks.astype(np.int32), lens


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", ZOO)
def test_ring_prefill_and_decode(arch, kv_quant):
    """Batched ring prefill (``max_len`` below the longest prompt, so the
    ring wraps) and three decode steps, each side from its own prefill,
    teacher-forced with the reference's greedy tokens."""
    cfg, pcfg, params, tp = model(arch)
    toks, lens = _prompts(cfg, 1, [16, 9, 5])
    off = np.array([0, 1000, 2000], np.int32)
    max_len = 24
    jl, jc = REF_PREFILL(params, cfg, jnp.asarray(toks), jnp.asarray(lens),
                         max_len, kv_quant=kv_quant,
                         kv_offset=jnp.asarray(off))
    tl, tc = registry.apply_prefill(
        tp, pcfg, torch.from_numpy(toks).long(), torch.from_numpy(lens),
        max_len, kv_quant=kv_quant, kv_offset=torch.from_numpy(off))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    assert np.array_equal(tc["layers"][0]["k_pos"].numpy(),
                          np.asarray(jc["layers"][0]["k_pos"]))
    cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for _ in range(3):
        jl, jc = REF_DECODE(params, cfg, jnp.asarray(cur), jc,
                            kv_offset=jnp.asarray(off))
        tl, tc = registry.apply_decode(tp, pcfg, torch.from_numpy(cur), tc,
                                       kv_offset=torch.from_numpy(off))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
        cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
    assert np.array_equal(tc["pos"].numpy(), lens + 3)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", ZOO)
def test_paged_prefill_and_decode(arch, kv_quant):
    """A cold paged prefill into shuffled pool blocks, then three paged
    decode steps crossing a block boundary, against the reference's (the
    reference's pool carried over as the starting cache)."""
    cfg, pcfg, params, tp = model(arch)
    toks, lens = _prompts(cfg, 4, [7, 12, 3])
    off = np.array([0, 1000, 2000], np.int32)
    ids = list(np.random.default_rng(5).permutation(NUM_BLOCKS))
    bt = np.full((3, MAX_LEN // BS), NUM_BLOCKS, np.int32)
    for i, n in enumerate(lens + 3):
        for j in range(-(-int(n) // BS)):
            bt[i, j] = ids.pop()
    starts = np.zeros(3, np.int32)
    jc = ref_tf.init_cache(cfg, 3, MAX_LEN, kv_quant=kv_quant,
                           kv_layout="paged", block_size=BS,
                           num_blocks=NUM_BLOCKS)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    jl, jc = REF_PREFILL_PAGED(
        params, cfg, jnp.asarray(toks), jnp.asarray(lens),
        jnp.asarray(starts), jnp.asarray(bt), jc, kv_quant=kv_quant,
        kv_offset=jnp.asarray(off))
    tl, tc = registry.apply_prefill_paged(
        tp, pcfg, torch.from_numpy(toks).long(), torch.from_numpy(lens),
        torch.from_numpy(starts), torch.from_numpy(bt), tc,
        kv_quant=kv_quant, kv_offset=torch.from_numpy(off))
    last = np.asarray(jl)[np.arange(3), lens - 1]
    np.testing.assert_allclose(tl.numpy(), last, atol=LOGIT_TOL, rtol=0)
    cur = np.argmax(last, -1).astype(np.int32)
    for _ in range(3):
        jl, jc = REF_DECODE_PAGED(params, cfg, jnp.asarray(cur), jc,
                                  kv_offset=jnp.asarray(off))
        tl, tc = registry.apply_decode(tp, pcfg, torch.from_numpy(cur), tc,
                                       kv_offset=torch.from_numpy(off))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
        cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
    assert np.array_equal(tc["pos"].numpy(), lens + 3)


def test_verify_raises_for_moe():
    """MoE has no speculative verify (capacity ranks would couple a verify
    row to its own later drafts): the engine refuses it and so does the
    model's verify forward."""
    from repro_torch.serve import Engine

    cfg, pcfg, params, tp = model("granite_moe_1b_a400m")
    assert not registry.supports_spec_decode(pcfg)
    assert registry.supports_paged_kv(pcfg)
    assert registry.supports_chunked_prefill(pcfg)
    with pytest.raises(ValueError, match="without MoE"):
        Engine(tp, pcfg, 2, 16, device="cpu", spec_decode=True)
    cache = transformer.init_cache(pcfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="no MoE form"):
        transformer.verify_step(tp, pcfg, torch.ones((2, 3), dtype=torch.long),
                                cache)
