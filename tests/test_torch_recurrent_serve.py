"""Serving the recurrent configs, mamba2-370m (SSD) and recurrentgemma-9b
(RG-LRU and local attention), at ``.reduced()`` on the CPU, against the
reference on the same weights (the port's init carried over,
``tests/_torch_zoo.py``): the scanned prefill (one decode step per prompt
position, short rows frozen), the engine's streams, decode windows,
restore, the paths the reference refuses, and local attention past the
window.

Tolerances, each for its reason:

* Logits within ``LOGIT_TOL`` = 2⁻⁶ (``tests/test_torch_model.py``; the
  scanned prefill's are within 0.0039 of the reference's, measured).
* Ring K/V are held to one bf16 ulp and int8 codes to |Δ| ≤ 1, as in
  ``tests/test_torch_model.py``; positions and int8 scales exactly
  (measured: K/V, codes and scales equal the reference's here).
* Recurrent states after a prefill: each layer's state of each row within
  ``STATE_TOL`` = 2⁻⁶ of that slice's own largest magnitude, not the
  rtol 1e-4 a single step is held to (``tests/test_torch_ssm.py``,
  ``tests/test_torch_hybrid.py``): a prefill is S steps through every
  layer, and the reference's CPU dot rounds a few bf16 projection outputs
  the other way (one ulp in 0.03 % of layer 0's), which enter the state
  every step and move later layers.  Measured at most 6.7e-3 of a
  slice's max |h| and 5.0e-3 of its max |conv| (mamba2); 1.1e-7 at
  recurrentgemma.  Element by element the bf16 conv window differs by
  whole ulps of small values, so no per-element rtol holds.
* Streams equal where every sampling decision of the reference clears
  twice 2⁻⁷ (``tests/test_torch_zoo_serve.py``'s check).
* Inside the port, the scanned prefill ≡ token-by-token decode, windows ≡
  single ticks and restore ≡ uninterrupted hold bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.serve.engine as port_engine
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_zoo import model, ref_jit
from repro.models import registry as ref_registry
from repro_torch import tree
from repro_torch.models import registry
from test_torch_zoo_serve import _port, _reference

LOGIT_TOL = 2.0 ** -6
STATE_TOL = 2.0 ** -6
RECURRENT = ["mamba2_370m", "recurrentgemma_9b"]
REF_PREFILL = ref_jit(ref_registry.apply_prefill, static_argnums=(1, 4),
                      static_argnames=("kv_quant",))
REF_DECODE = ref_jit(ref_registry.apply_decode)


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_cache_close(got, want):
    """A port cache against a reference cache, leaf by leaf in JAX's
    order, with the tolerances of the module docstring."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = tree.leaves(got)
    assert len(flat) == len(leaves)
    for (path, w), g in zip(flat, leaves):
        name = jax.tree_util.keystr(path)
        codes = g.dtype == torch.int8
        w, g = _np(w).astype(np.float64), _np(g).astype(np.float64)
        assert w.shape == g.shape, name
        if name.endswith(("['h']", "['conv']")):
            # one slice per (layer, row): a remainder leaf has no layer axis
            lead = 2 if name.startswith("['layers']") else 1
            w, g = (x.reshape(x.shape[:lead] + (-1,)) for x in (w, g))
            scale = np.abs(w).max(-1)
            assert np.all(np.abs(w - g).max(-1) <= STATE_TOL * scale), name
        elif name.endswith(("['k']", "['v']")):
            mag = np.maximum(np.abs(w), np.abs(g))
            ulp = (1.0 if codes else
                   np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7))
            assert np.all(np.abs(w - g) <= ulp), name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _prefill_inputs(cfg, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(4, 16)).astype(np.int32)
    lens = np.array([13, 5, 0, 16], np.int32)     # row 2 inactive
    off = np.array([0, 7, 3, 1000], np.int32)
    return toks, lens, off


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_scanned_prefill_matches_reference(arch, kv_quant):
    """``registry.apply_prefill``'s scanned prefill: last-token logits,
    positions, the ring KV and the recurrent states against the
    reference's, short rows frozen at their length and the empty row
    untouched."""
    cfg, pcfg, params, tp = model(arch)
    toks, lens, off = _prefill_inputs(pcfg)
    want_logits, want = REF_PREFILL(params, cfg, jnp.asarray(toks),
                                    jnp.asarray(lens), 32, kv_quant=kv_quant,
                                    kv_offset=jnp.asarray(off))
    got_logits, got = registry.apply_prefill(
        tp, pcfg, torch.from_numpy(toks).long(), torch.from_numpy(lens), 32,
        kv_quant=kv_quant, kv_offset=torch.from_numpy(off))
    assert np.abs(got_logits.numpy() - np.asarray(want_logits)).max() \
        <= LOGIT_TOL
    assert got["pos"].tolist() == lens.tolist()
    _assert_cache_close(got, want)
    # the inactive row stays a fresh row
    for leaf in tree.leaves({"layers": got["layers"],
                             "remainder": got["remainder"]}):
        row = leaf[:, 2] if leaf.dim() > 1 and leaf.shape[1] == 4 else None
        if row is not None:
            assert bool((row == 0).all() or (row == -1).all())


@pytest.mark.parametrize("arch", RECURRENT)
def test_scanned_prefill_is_token_by_token_decode(arch):
    """The scanned prefill is the decode step fed the prompt token by
    token, bit for bit: logits, positions and every cache tensor (the
    reference's ``tests/test_serve.py`` pins the same through greedy
    streams)."""
    _, pcfg, _, tp = model(arch)
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(1, pcfg.vocab_size, size=(2, 5)))
    lens = torch.tensor([5, 5], dtype=torch.int32)
    logits, cache = registry.apply_prefill(tp, pcfg, toks, lens, 32)
    step = registry.make_cache(tp, pcfg, 2, 32, device="cpu")
    for t in range(5):
        step_logits, step = registry.apply_decode(tp, pcfg, toks[:, t], step)
    assert torch.equal(logits, step_logits)
    assert torch.equal(cache["pos"], step["pos"])
    for a, b in zip(tree.leaves(cache), tree.leaves(step)):
        assert torch.equal(a, b)
    # and the engine's greedy streams are token-by-token greedy decode
    eng = port_engine.Engine(tp, pcfg, 2, 32, device="cpu")
    for r in range(2):
        eng.submit(port_engine.Request(rid=r, prompt=toks[r].tolist(),
                                       max_new=5))
    done = sorted(eng.run(60), key=lambda r: r.rid)
    want = []
    tok = torch.argmax(step_logits, -1)
    for _ in range(5):
        want.append(tok)
        step_logits, step = registry.apply_decode(tp, pcfg, tok, step)
        tok = torch.argmax(step_logits, -1)
    assert [r.out for r in done] == torch.stack(want, 1).tolist()


# (arch, kv_quant, decode_ticks, seed): the seeds pass the margin check
STREAM_CASES = [("mamba2_370m", False, 1, 2), ("recurrentgemma_9b", True, 1, 1),
                ("recurrentgemma_9b", False, 4, 5), ("mamba2_370m", True, 4, 2)]


@pytest.mark.parametrize("arch,kv_quant,ticks,seed", STREAM_CASES)
def test_engine_streams_equal_reference(arch, kv_quant, ticks, seed,
                                        monkeypatch):
    """Greedy and sampled streams of the port's ring engine equal the
    reference engine's, request by request, in single ticks and in
    windows of 4 (a slot finishing mid-window leaves its row inert)."""
    ref = _reference(arch, "ring", kv_quant, None, ticks, seed, monkeypatch)
    port, _ = _port(arch, "ring", kv_quant, None, ticks, seed)
    assert port == ref


def _requests(vocab, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [port_engine.Request(
        rid=r, prompt=rng.integers(1, vocab, size=int(rng.integers(3, 14)))
        .tolist(), sampling=port_engine.SamplingParams(
            temperature=0.8 * (r % 2), seed=r, max_new=3 + 3 * r,
            counter_offset=100 * r)) for r in range(n)]


def _serve(tp, pcfg, **kw):
    eng = port_engine.Engine(tp, pcfg, 2, 32, device="cpu", **kw)
    for req in _requests(pcfg.vocab_size):
        eng.submit(req)
    eng.run(200)
    return eng


def _streams(eng):
    return {r.rid: (list(r.out), r.finish_reason) for r in eng.finished}


@pytest.mark.parametrize("arch", RECURRENT)
def test_windows_equal_single_ticks(arch):
    """W = 4 windows give the one-tick streams, slots finishing and being
    refilled mid-window, bit for bit."""
    _, pcfg, _, tp = model(arch)
    one = _serve(tp, pcfg)
    four = _serve(tp, pcfg, decode_ticks=4)
    assert _streams(four) == _streams(one)
    assert four.stats["decode_calls"] < one.stats["decode_calls"]


@pytest.mark.parametrize("arch", RECURRENT)
def test_paged_chunked_and_spec_are_refused(arch):
    """The reference gives recurrent configs no paged cache, no chunked
    prefill and no speculative decoding; the port refuses them with the
    reference's errors."""
    _, pcfg, _, tp = model(arch)
    assert not registry.supports_paged_kv(pcfg)
    assert not registry.supports_chunked_prefill(pcfg)
    assert not registry.supports_spec_decode(pcfg)
    for kw, match in ((dict(kv_layout="paged", block_size=8), "paged"),
                      (dict(prefill_chunk=8), "chunked prefill"),
                      (dict(spec_decode=True), "spec_decode")):
        with pytest.raises(ValueError, match=match):
            port_engine.Engine(tp, pcfg, 2, 32, device="cpu", **kw)
    with pytest.raises(ValueError, match="recurrent state"):
        registry.make_cache(tp, pcfg, 2, 32, kv_layout="paged", block_size=8,
                            device="cpu")


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_restore_is_uninterrupted_bit_for_bit(arch, kv_quant):
    """Snapshots at every step, with the two slots at unequal generated
    lengths: restored in place, the cache's written positions and states
    equal the uninterrupted engine's byte for byte, and the streams
    finish equal (the replay keeps a row out of tokens inert, its state
    too)."""
    _, pcfg, _, tp = model(arch)
    want = _serve(tp, pcfg, kv_quant=kv_quant, decode_ticks=2)
    unequal = 0
    for stop in range(1, 9):
        eng = port_engine.Engine(tp, pcfg, 2, 32, device="cpu",
                                 kv_quant=kv_quant, decode_ticks=2)
        for req in _requests(pcfg.vocab_size):
            eng.submit(req)
        for _ in range(stop):
            eng.step()
        lens = {len(r.out) for r in eng.slots if r is not None}
        unequal += len(lens) > 1
        before = eng.written_kv()
        eng.restore(json.loads(json.dumps(eng.snapshot())))
        port_engine.Engine.compare_written_kv(before, eng.written_kv())
        eng.run(200)
        assert _streams(eng) == _streams(want), stop
    assert unequal >= 2


def test_local_attention_past_the_window():
    """recurrentgemma's local attention (window 64 at ``.reduced()``): a
    ring of 64 slots written past position 64 wraps, and decode logits
    keep matching the reference's, bf16 and int8."""
    cfg, pcfg, params, tp = model("recurrentgemma_9b")
    assert pcfg.window == 64
    rng = np.random.default_rng(4)
    toks = rng.integers(1, pcfg.vocab_size, size=(2, 60)).astype(np.int32)
    lens = np.array([60, 41], np.int32)
    for kv_quant in (False, True):
        _, jc = REF_PREFILL(params, cfg, jnp.asarray(toks), jnp.asarray(lens),
                            128, kv_quant=kv_quant)
        _, tc = registry.apply_prefill(tp, pcfg, torch.from_numpy(toks).long(),
                                       torch.from_numpy(lens), 128,
                                       kv_quant=kv_quant)
        assert tuple(tc["layers"][2]["k"].shape[2:3]) == (64,)
        for t in range(30):
            cur = rng.integers(1, pcfg.vocab_size, size=2).astype(np.int32)
            jl, jc = REF_DECODE(params, cfg, jnp.asarray(cur), jc)
            tl, tc = registry.apply_decode(tp, pcfg, torch.from_numpy(cur),
                                           tc)
            assert np.abs(tl.numpy() - np.asarray(jl)).max() <= LOGIT_TOL, t
        assert tc["pos"].tolist() == [90, 71]
        assert int(tc["layers"][2]["k_pos"].max()) == 89
