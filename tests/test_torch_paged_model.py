"""The port's paged cache, paged prefill and paged decode step against the
reference's, on the same weights, at ``smollm_135m.reduced()``.

Tolerances, each for its reason (as in ``tests/test_torch_model.py``):

* The first layer's pool: int8 codes and scales **bitwise**, bf16 K/V
  within one bf16 ulp.  Layer 0 sees only the embedding, and the
  projections, the scatter and the quantiser are bitwise for the same
  inputs.  The pool compared is a second prefill's, run with the
  reference's ``rms_norm`` and ``rope``
  (``_torch_equal_inputs.reference_norm_and_rope``, which says why) so
  that its layer-0 K/V are made from identical f32 inputs; the logits
  and positions come from the port's prefill on its own ops.  Deeper
  layers' K/V come out of the previous layers' bf16 activations,
  which differ from the reference's by bf16 ulps (see below), so they are
  held through the logits.
* Logits within ``LOGIT_TOL`` = 2⁻⁶: the reference's jit keeps excess f32
  precision through some bf16 intermediates and sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import registry as ref_registry
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config
from repro_torch.interop import cache_from_numpy, params_from_numpy
from repro_torch.models import registry, transformer
from _torch_equal_inputs import reference_norm_and_rope
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = ref_get_config("smollm_135m").reduced()
PCFG = get_config("smollm_135m").reduced()
PARAMS = ref_registry.init_model(jax.random.PRNGKey(0), CFG)
TORCH_PARAMS = params_from_numpy(jax.tree.map(np.asarray, PARAMS), "cpu")
LOGIT_TOL = 2.0 ** -6
BS, MAX_LEN, NUM_BLOCKS = 4, 32, 20


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_bf16_ulps(got, want, n=1):
    got, want = _f32(got).astype(np.float64), _f32(want).astype(np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= n * ulp), np.abs(got - want).max()


def _assert_pool(tc, jc, kv_quant):
    """The first layer's pool (trash block excluded) against the
    reference's: int8 codes and scales bitwise, bf16 within one ulp."""
    want = jax.tree.map(lambda t: np.asarray(t[0])[:NUM_BLOCKS],
                        jc["layers"][0])
    got = {k: v[0][:NUM_BLOCKS] for k, v in tc["layers"][0].items()}
    assert sorted(got) == sorted(want)
    for name in ("k", "v"):
        if kv_quant:
            assert np.array_equal(got[name].numpy(), want[name]), name
        else:
            _assert_bf16_ulps(got[name], want[name])
    for name in ("k_scale", "v_scale") if kv_quant else ():
        assert np.array_equal(got[name].numpy().view(np.uint32),
                              want[name].view(np.uint32)), name


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_init_cache_paged_shapes(kv_quant):
    """num_blocks usable blocks plus the trash block, tables on the trash
    id, the reference's shapes and dtypes leaf for leaf."""
    jc = ref_tf.init_cache(CFG, 3, MAX_LEN, kv_quant=kv_quant,
                           kv_layout="paged", block_size=BS, num_blocks=7)
    tc = transformer.init_cache(PCFG, 3, MAX_LEN, kv_quant=kv_quant,
                                kv_layout="paged", block_size=BS,
                                num_blocks=7, device="cpu")
    assert sorted(tc) == sorted(jc)
    assert tuple(tc["block_tables"].shape) == (3, MAX_LEN // BS)
    assert (tc["block_tables"] == 7).all()
    assert tc["block_tables"].dtype == torch.int32
    for name, want in jc["layers"][0].items():
        got = tc["layers"][0][name]
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
    assert tc["layers"][0]["k"].shape[1] == 8        # 7 blocks + trash
    dflt = transformer.init_cache(PCFG, 3, 30, kv_layout="paged",
                                  block_size=BS, device="cpu")
    assert dflt["layers"][0]["k"].shape[1] == 3 * 8 + 1     # 3 × ceil(30/4)


def _tables(lens, starts, shared=None):
    """Block tables for prompts of ``starts + lens`` tokens: physical ids
    handed out in a shuffled order; rows listed in ``shared`` reuse row 0's
    first blocks (a prefix hit)."""
    rng = np.random.default_rng(5)
    ids = list(rng.permutation(NUM_BLOCKS))
    bt = np.full((len(lens), MAX_LEN // BS), NUM_BLOCKS, np.int32)
    for i, (n, st) in enumerate(zip(lens, starts)):
        for j in range(-(-(int(n) + int(st)) // BS)):
            if shared and i in shared and j < st // BS:
                bt[i, j] = bt[0, j]
            else:
                bt[i, j] = ids.pop()
    return bt


def _port_prefill(toks, lens, starts, bt, tc, kv_quant, off, prefix_blocks):
    return transformer.prefill_with_cache_paged(
        TORCH_PARAMS, PCFG, torch.from_numpy(toks).long(),
        torch.from_numpy(lens), torch.from_numpy(starts),
        torch.from_numpy(bt), tc, kv_quant=kv_quant,
        kv_offset=torch.from_numpy(off), prefix_blocks=prefix_blocks)


def _both_prefill(toks, lens, starts, bt, jc, tc, kv_quant, off,
                  prefix_blocks, eq=None):
    """The reference's prefill and the port's, on its own ops, from the
    same inputs: (jl, jc, tl, tc).  ``eq``: a second port cache, which the
    same prefill fills under ``reference_norm_and_rope`` (its layer-0
    pool is the one held to the reference's); returned last."""
    jl, jc = ref_tf.prefill_with_cache_paged(
        PARAMS, CFG, jnp.asarray(toks), jnp.asarray(lens),
        jnp.asarray(starts), jnp.asarray(bt), jc, kv_quant=kv_quant,
        kv_offset=jnp.asarray(off), prefix_blocks=prefix_blocks)
    args = (toks, lens, starts, bt)
    tl, tc = _port_prefill(*args, tc, kv_quant, off, prefix_blocks)
    if eq is None:
        return jl, jc, tl, tc
    with reference_norm_and_rope():
        _, eq = _port_prefill(*args, eq, kv_quant, off, prefix_blocks)
    return jl, jc, tl, tc, eq


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_prefill_paged_cold_and_prefix_hit(kv_quant):
    """A cold wave writes three prompts into shuffled pool blocks; a second
    wave hits row 0's first two blocks (8 tokens) and prefills only its
    suffix, joining the gathered prefix inside attention.  Pool contents
    and logits match the reference after each wave."""
    rng = np.random.default_rng(3)
    off = np.array([0, 1000, 0], np.int32)
    lens = np.array([11, 6, 0], np.int32)
    starts = np.zeros(3, np.int32)
    toks = rng.integers(1, CFG.vocab_size, size=(3, 16)).astype(np.int32)
    bt = _tables(lens, starts)
    jc = ref_tf.init_cache(CFG, 3, MAX_LEN, kv_quant=kv_quant,
                           kv_layout="paged", block_size=BS,
                           num_blocks=NUM_BLOCKS)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    eq = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    jl, jc, tl, tc, eq = _both_prefill(toks, lens, starts, bt, jc, tc,
                                       kv_quant, off, 0, eq)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    _assert_pool(eq, jc, kv_quant)

    # wave 2: row 2 shares row 0's first 8 tokens (2 blocks) and the offset
    suffix = rng.integers(1, CFG.vocab_size, size=5).astype(np.int32)
    toks2 = np.zeros((3, 8), np.int32)
    toks2[2, :5] = suffix
    lens2 = np.array([0, 0, 5], np.int32)
    starts2 = np.array([0, 0, 8], np.int32)
    bt2 = bt.copy()
    bt2[2, :2] = bt[0, :2]
    used = set(bt[bt < NUM_BLOCKS].tolist())
    bt2[2, 2:4] = [i for i in range(NUM_BLOCKS) if i not in used][:2]
    jl, jc, tl, tc, eq = _both_prefill(toks2, lens2, starts2, bt2, jc, tc,
                                       kv_quant, off, MAX_LEN // BS, eq)
    np.testing.assert_allclose(tl.numpy()[2], np.asarray(jl)[2],
                               atol=LOGIT_TOL, rtol=0)
    assert tc["pos"][2].item() == 13
    _assert_pool(eq, jc, kv_quant)

    # in bf16 the prefix hit equals a cold prefill of the whole 13-token
    # prompt (an int8 hit reads its prefix back dequantised, so there only
    # the streams are compared: tests/test_torch_paged_serve.py)
    if kv_quant:
        return
    cold = transformer.init_cache(PCFG, 1, MAX_LEN, kv_quant=kv_quant,
                                  kv_layout="paged", block_size=BS,
                                  num_blocks=NUM_BLOCKS, device="cpu")
    full = np.concatenate([toks[0, :8], suffix])[None].astype(np.int64)
    cl, _ = transformer.prefill_with_cache_paged(
        TORCH_PARAMS, PCFG, torch.from_numpy(full), torch.tensor([13]),
        torch.tensor([0]), torch.from_numpy(bt2[2:3]), cold,
        kv_quant=kv_quant, kv_offset=torch.tensor([0]))
    np.testing.assert_allclose(tl.numpy()[2, :5], cl.numpy()[0, 8:13],
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_decode_step_paged(kv_quant):
    """Three paged decode steps after a cold paged prefill, each side from
    its own prefill, teacher-forced with the reference's greedy tokens;
    the new tokens cross a block boundary into freshly tabled blocks."""
    rng = np.random.default_rng(4)
    off = np.array([0, 1000, 2000], np.int32)
    lens = np.array([7, 12, 3], np.int32)
    starts = np.zeros(3, np.int32)
    toks = rng.integers(1, CFG.vocab_size, size=(3, 16)).astype(np.int32)
    bt = _tables(lens + 3, starts)
    jc = ref_tf.init_cache(CFG, 3, MAX_LEN, kv_quant=kv_quant,
                           kv_layout="paged", block_size=BS,
                           num_blocks=NUM_BLOCKS)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    jl, jc, tl, tc = _both_prefill(toks, lens, starts, bt, jc, tc, kv_quant,
                                   off, 0)
    last = np.asarray(jl)[np.arange(3), lens - 1]
    cur = np.argmax(last, -1).astype(np.int32)
    for _ in range(3):
        jl, jc = ref_tf.decode_step(PARAMS, CFG, jnp.asarray(cur), jc,
                                    kv_offset=jnp.asarray(off))
        tl, tc = registry.apply_decode(TORCH_PARAMS, PCFG,
                                       torch.from_numpy(cur), tc,
                                       kv_offset=torch.from_numpy(off))
        assert tl.shape == (3, CFG.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
        cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
    assert np.array_equal(tc["pos"].numpy(), lens + 3)
    assert torch.equal(tc["block_tables"], torch.from_numpy(bt))
    _assert_pool(tc, jc, kv_quant)


def test_decode_from_reference_paged_cache():
    """``interop.cache_from_numpy`` carries a reference paged pool over bit
    for bit, and the port decodes from it."""
    rng = np.random.default_rng(6)
    lens = np.array([9, 5], np.int32)
    toks = rng.integers(1, CFG.vocab_size, size=(2, 16)).astype(np.int32)
    bt = _tables(lens + 1, np.zeros(2, np.int32))
    jc = ref_tf.init_cache(CFG, 2, MAX_LEN, kv_quant=True, kv_layout="paged",
                           block_size=BS, num_blocks=NUM_BLOCKS)
    _, jc = ref_tf.prefill_with_cache_paged(
        PARAMS, CFG, jnp.asarray(toks), jnp.asarray(lens),
        jnp.zeros(2, jnp.int32), jnp.asarray(bt), jc, kv_quant=True)
    np_cache = jax.tree.map(np.asarray, jc)
    tc = cache_from_numpy(np_cache, "cpu")
    assert np.array_equal(tc["layers"][0]["k"].numpy(),
                          np_cache["layers"][0]["k"])
    assert np.array_equal(tc["block_tables"].numpy(), bt)
    cur = np.array([3, 4], np.int32)
    jl, _ = ref_tf.decode_step(PARAMS, CFG, jnp.asarray(cur), jc)
    tl, _ = transformer.decode_step(TORCH_PARAMS, PCFG,
                                    torch.from_numpy(cur), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
