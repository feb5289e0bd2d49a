"""The port's speculative verify forward (``transformer.verify_step``) and
bulk commit (``transformer.spec_commit``) at ``smollm_135m.reduced()``:
against the reference's on the same weights and cache, and against the
port's own decode step, which they must reproduce bit for bit.

Tolerances, each for its reason (as in ``tests/test_torch_model.py``):

* Verify logits against the reference's within ``LOGIT_TOL`` = 2⁻⁶; the
  first layer's written K/V within one bf16 ulp, its int8 codes within
  one code and scales within one bf16 ulp (a K/V ulp may move a code).
* Inside the port, **bitwise**: verify row t equals ``decode_step`` at
  ``pos + t`` after decoding the drafts before it, with the library ops
  fused over the K rows or run per row; the cache a verify writes equals
  the one K decode steps write; after ``spec_commit`` the cache holds the
  bytes of one that only ever decoded the accepted tokens.
"""

import copy

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
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = ref_get_config("smollm_135m").reduced()
PCFG = get_config("smollm_135m").reduced()
PARAMS = ref_registry.init_model(jax.random.PRNGKey(0), CFG)
TORCH_PARAMS = params_from_numpy(jax.tree.map(np.asarray, PARAMS), "cpu")
LOGIT_TOL = 2.0 ** -6
K, BS, MAX_LEN, NUM_BLOCKS = 4, 4, 32, 40


def _inputs(seed, b=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, CFG.vocab_size, size=(b, 16)).astype(np.int32)
    lens = np.array([16, 9, 5, 11][:b], np.int32)
    off = np.array([0, 1000, 2000, 77][:b], np.int32)
    drafts = rng.integers(1, CFG.vocab_size, size=(b, K)).astype(np.int32)
    return toks, lens, off, drafts


def _tables(b):
    """Each row owns MAX_LEN // BS blocks, handed out shuffled."""
    ids = np.random.default_rng(5).permutation(NUM_BLOCKS)
    nb = MAX_LEN // BS
    return ids[: b * nb].reshape(b, nb).astype(np.int32)


def _reference_cache(layout, kv_quant, toks, lens, off):
    """The reference's cache after a batched prefill, and the port's copy."""
    if layout == "ring":
        _, jc = ref_tf.prefill_with_cache(
            PARAMS, CFG, jnp.asarray(toks), jnp.asarray(lens), MAX_LEN,
            kv_quant=kv_quant, kv_offset=jnp.asarray(off))
    else:
        jc = ref_tf.init_cache(CFG, len(lens), MAX_LEN, kv_quant=kv_quant,
                               kv_layout="paged", block_size=BS,
                               num_blocks=NUM_BLOCKS)
        _, jc = ref_tf.prefill_with_cache_paged(
            PARAMS, CFG, jnp.asarray(toks), jnp.asarray(lens),
            jnp.zeros(len(lens), jnp.int32), jnp.asarray(_tables(len(lens))),
            jc, kv_quant=kv_quant, kv_offset=jnp.asarray(off))
    return jc, cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")


def _port_cache(layout, kv_quant, toks, lens, off):
    """The port's own cache after a batched prefill."""
    t = [torch.from_numpy(a) for a in (toks, lens, off)]
    if layout == "ring":
        _, cache = registry.apply_prefill(TORCH_PARAMS, PCFG, t[0].long(),
                                          t[1], MAX_LEN, kv_quant=kv_quant,
                                          kv_offset=t[2])
        return cache
    cache = registry.make_cache(TORCH_PARAMS, PCFG, len(lens), MAX_LEN,
                                kv_quant=kv_quant, kv_layout="paged",
                                block_size=BS, num_blocks=NUM_BLOCKS,
                                device="cpu")
    _, cache = registry.apply_prefill_paged(
        TORCH_PARAMS, PCFG, t[0].long(), t[1], torch.zeros_like(t[1]),
        torch.from_numpy(_tables(len(lens))), cache, kv_quant=kv_quant,
        kv_offset=t[2])
    return cache


def _bf16_ulps(got, want):
    got, want = got.astype(np.float64), want.astype(np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    return np.abs(got - want) / np.exp2(
        np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_verify_step_matches_reference(layout, kv_quant):
    """Both sides verify K drafts over the same carried-over cache: logits
    within 2⁻⁶, the first layer's written K/V as its prefill is held."""
    toks, lens, off, drafts = _inputs(1)
    jc, tc = _reference_cache(layout, kv_quant, toks, lens, off)
    jl, jc = ref_tf.verify_step(PARAMS, CFG, jnp.asarray(drafts), jc,
                                kv_offset=jnp.asarray(off))
    tl, tc = registry.apply_verify(TORCH_PARAMS, PCFG,
                                   torch.from_numpy(drafts), tc,
                                   kv_offset=torch.from_numpy(off))
    assert tl.shape == (3, K, CFG.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    assert np.array_equal(tc["pos"].numpy(), lens)          # not advanced
    want = jax.tree.map(lambda t: np.asarray(t[0]), jc["layers"][0])
    got = {k: v[0].float().numpy() if v.dtype == torch.bfloat16
           else v[0].numpy() for k, v in tc["layers"][0].items()}
    assert sorted(got) == sorted(want)
    for name in ("k", "v"):
        if kv_quant:
            d = np.abs(got[name].astype(int) - want[name].astype(int))
            assert d.max() <= 1, name
        else:
            assert _bf16_ulps(got[name], want[name].astype(np.float32)).max() \
                <= 1, name
    for name in ("k_scale", "v_scale") if kv_quant else ():
        assert _bf16_ulps(got[name], want[name]).max() <= 1, name
    if layout == "ring":
        assert np.array_equal(got["k_pos"], want["k_pos"])


@pytest.mark.parametrize("probed", [False, True], ids=["per_row", "probed"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_verify_rows_equal_decode_steps(layout, kv_quant, probed):
    """Row t of a verify step is bit for bit the logits of ``decode_step``
    at ``pos + t`` after decoding drafts 0..t-1, whether every library op
    runs per row at decode's shape or those ``row_purity`` finds row-pure
    run fused over the K rows (as the engine runs them); and the K
    positions the verify writes hold exactly the bytes K decode steps
    write."""
    toks, lens, off, drafts = _inputs(2)
    cache = _port_cache(layout, kv_quant, toks, lens, off)
    seq = copy.deepcopy(cache)
    offset = torch.from_numpy(off)
    fused = frozenset()
    if probed:
        fused = frozenset(op for op, n in transformer.row_purity(
            TORCH_PARAMS, PCFG, len(lens), K).items() if n == 0)
    logits, cache = transformer.verify_step(
        TORCH_PARAMS, PCFG, torch.from_numpy(drafts), cache,
        kv_offset=offset, fused_ops=fused)
    for t in range(K):
        want, seq = transformer.decode_step(
            TORCH_PARAMS, PCFG, torch.from_numpy(drafts[:, t]), seq,
            kv_offset=offset)
        assert torch.equal(logits[:, t], want), t
    for got, want in zip(cache["layers"], seq["layers"]):
        for name in got:
            assert torch.equal(got[name], want[name]), name


def _rows_of(cache, layout, row, upto):
    """Slot ``row``'s cache bytes at positions < ``upto``, per layer and
    tensor: the ring row, or the positions of its table's blocks."""
    out = []
    for entry in cache["layers"]:
        for name, t in sorted(entry.items()):
            if layout == "ring":
                out.append((name, t[:, row]))
            else:
                bt = cache["block_tables"][row].long()
                flat = t[:, bt].reshape((t.shape[0], -1) + t.shape[3:])
                out.append((name, flat[:, :upto]))
    return out


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_spec_commit_restores_the_never_drafted_cache(layout, kv_quant):
    """Verify K drafts with per-row write budgets (4, 4, 2, and a dead row),
    accept 1, 3, 2 and 0 of them, commit: every slot's cache holds the
    bytes of one that decoded only its accepted tokens — the ring row
    whole, the paged blocks at every position below the new ``pos`` — the
    scrubbed positions are never-written (0, k_pos -1), and ``pos`` is
    the committed one."""
    toks, lens, off, drafts = _inputs(3, b=4)
    cache = _port_cache(layout, kv_quant, toks, lens, off)
    offset = torch.from_numpy(off)
    snaps = [copy.deepcopy(cache)]                # after j decode steps
    for t in range(K):
        _, c = transformer.decode_step(TORCH_PARAMS, PCFG,
                                       torch.from_numpy(drafts[:, t]),
                                       copy.deepcopy(snaps[-1]),
                                       kv_offset=offset)
        snaps.append(c)
    alive = torch.tensor([True, True, True, False])
    wcap = torch.tensor([4, 4, 2, 0], dtype=torch.int32)
    accept = np.array([1, 3, 2, 0])
    _, cache = transformer.verify_step(TORCH_PARAMS, PCFG,
                                       torch.from_numpy(drafts), cache,
                                       kv_offset=offset, alive=alive,
                                       wcap=wcap)
    new_pos = torch.from_numpy(lens + accept)
    cache = transformer.spec_commit(cache, new_pos, wcap, draft_k=K)
    assert torch.equal(cache["pos"], new_pos)
    for row in range(4):
        upto = int(new_pos[row])
        got = _rows_of(cache, layout, row, upto)
        want = _rows_of(snaps[accept[row]], layout, row, upto)
        for (name, g), (_, w) in zip(got, want):
            assert torch.equal(g, w), (row, name)
        stale = _rows_of(cache, layout, row, int(lens[row]) + int(wcap[row]))
        for name, g in stale:
            blank = -1 if name == "k_pos" else 0
            if layout == "ring":
                cols = torch.arange(upto, int(lens[row]) + int(wcap[row]))
                g = g[:, cols]
            else:
                g = g[:, upto:]
            assert (g == blank).all(), (row, name)


def test_row_purity_sees_a_reordered_sum():
    """``row_purity`` counts, per library op of the verify forward, the
    outputs that change bits when the op runs over K rows at once (the
    engine fuses the ops at 0).  Its inputs make a reordered f32 sum show
    through the bf16 output: a matmul that sums each row in an order
    depending on the row count — here, split in two halves for more than
    one row — is caught."""
    got = registry.verify_row_purity(TORCH_PARAMS, PCFG, 2, K)
    assert sorted(got) == sorted(transformer.VERIFY_OPS)
    assert all(isinstance(n, int) and n >= 0 for n in got.values())

    def split_when_batched(a, w, *args, **kw):
        af, wf = a.float(), w.float()
        if af.reshape(-1, af.shape[-1]).shape[0] == a.shape[0]:
            return torch.matmul(af, wf).to(a.dtype)
        h = af.shape[-1] // 2
        return (torch.matmul(af[..., :h], wf[:h])
                + torch.matmul(af[..., h:], wf[h:])).to(a.dtype)

    original = transformer.dense
    try:
        transformer.dense = split_when_batched
        split = transformer.row_purity(TORCH_PARAMS, PCFG, 2, K)
    finally:
        transformer.dense = original
    assert all(split[op] > 0 for op in transformer.VERIFY_OPS
               if op != "rms_norm"), split
