"""The port's overlapped engine (DESIGN.md §11) at ``smollm_135m.reduced()``
on the CPU: decode windows of ``decode_ticks`` ticks and chunked
piggyback prefill (``prefill_chunk``), against the port's own single
ticks and whole-prompt prefill and against the reference's engine, on the
reference's weights (``interop.params_from_numpy``).

Parity classes, each for its reason:

* **window ≡ single ticks, bitwise** (port against port): a window runs
  the one-tick window's ops for every live slot and freezes dead ones, so
  every stream and finish reason is equal for any window length — greedy
  and sampled, ring and paged, bf16 and int8, under pool pressure, and
  under the dither policy (its counter is tick + j) when every request is
  admitted at tick 0 (later admissions land on other ticks when a window
  runs past a finish, and the policy's counter is the tick).
* **port windows ≡ reference windows**: the reference's decode_ticks=4
  streams, on ``tests/test_torch_serve.py``'s and
  ``tests/test_torch_paged_serve.py``'s margin-checked fixtures (their
  single-tick reference runs check every decision against ``LOGIT_TOL``
  = 2⁻⁶; the reference's own window is bitwise its single ticks, which is
  asserted here too).
* **chunked prefill against the reference's**: the classes
  ``tests/test_torch_model.py`` holds ``prefill_with_cache`` to — logits
  within ``LOGIT_TOL``, positions and ``k_pos`` exact, the first layer's
  cache within one bf16 ulp or one int8 code.  The logits come from the
  port's chunked prefill on its own ops; the cache compared from a
  second one run with the reference's norm and RoPE
  (``_torch_equal_inputs``: on an AVX-512 host the two libraries' f32
  sums differ in a way that moves layer 0's V by two bf16 ulps, and the
  seed's test fails there).
* **chunked ≡ whole-prompt, to rounding**: a chunk writes the codes
  whole-prompt prefill writes, but joining the ring history (or the
  paged prefix) re-associates the softmax, so the logits move: at most
  0.0166 over chunks of 2–16 tokens, bf16 and int8, on this model.
  ``CHUNK_TOL`` = 2⁻⁵ (max) and 2⁻⁷ (mean) bound it, and stream equality
  is asked only where every decision of the whole-prompt run clears twice
  ``CHUNK_TOL`` (``test_torch_serve._check_decision``).  At that margin
  greedy decisions of the reduced model do not clear (its top two logits
  are often one bf16 ulp apart or tied), so those fixtures sample at
  temperature 2; a fixture that fails the check is reseeded, never
  loosened.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_paged_serve import _reference_paged, _stream_requests
from test_torch_serve import _check_decision, _reference, _requests

import repro.serve.engine as ref_engine
import repro_torch.serve.engine as port_engine
from repro.configs import get_config
from repro.models import registry as ref_registry
from repro_torch.configs import get_config as port_get_config
from repro_torch.interop import cache_from_numpy, params_from_numpy
from repro_torch.models import registry
from repro_torch.numerics.policy import QuantPolicy
from repro_torch.serve import Engine, Request, SamplingParams
from _torch_equal_inputs import reference_norm_and_rope
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = get_config("smollm_135m").reduced()
PCFG = port_get_config("smollm_135m").reduced()
PARAMS = ref_registry.init_model(jax.random.PRNGKey(0), CFG)
TORCH_PARAMS = params_from_numpy(jax.tree.map(np.asarray, PARAMS), "cpu")
LOGIT_TOL = 2.0 ** -6          # port vs reference logits
CHUNK_TOL, CHUNK_MEAN_TOL = 2.0 ** -5, 2.0 ** -7   # chunked vs whole prompt
BLOCK = 8                      # paged pool block size under test
TEMPERATURE = 2.0              # the margin-checked chunk fixtures


def _mix(n=6):
    """The reference's window fixture (``tests/test_overlap.py::_mix``)."""
    return [[(13 * r + i) % (CFG.vocab_size - 1) + 1
             for i in range(6 + 3 * r)] for r in range(n)]


def _sampled(prompts, seed):
    """Prompts → requests sampled at ``TEMPERATURE`` (full vocabulary), 4
    new tokens each, EOS and a stop id as the reference's fixture."""
    return [Request(rid=r, prompt=list(p), sampling=SamplingParams(
        temperature=TEMPERATURE, max_new=4, seed=seed + r, eos_id=11,
        stop_ids=(77,), counter_offset=500 * r)) for r, p in
        enumerate(prompts)]


def _greedy(prompts, *, temperature=0.0, max_new=6):
    return [Request(rid=r, prompt=list(p), sampling=SamplingParams(
        temperature=temperature, max_new=max_new, seed=r, eos_id=11,
        stop_ids=(77,), counter_offset=500 * r)) for r, p in
        enumerate(prompts)]


def _serve(reqs, *, batch=2, max_len=48, **eng_kw):
    """Serve ``reqs`` on a fresh CPU engine → the stream fingerprint
    [(rid, tokens, finish reason)] and the engine."""
    if eng_kw.get("kv_layout") == "paged":
        eng_kw.setdefault("block_size", BLOCK)
    eng = Engine(TORCH_PARAMS, PCFG, batch, max_len, device="cpu", **eng_kw)
    for req in reqs:
        eng.submit(req)
    done = eng.run(400)
    assert len(done) == len(reqs)
    return sorted((d.rid, tuple(d.out), d.finish_reason) for d in done), eng


def _recording_sampler(monkeypatch):
    """Record every sampler call of the port's engine with the rows whose
    token the engine keeps: a window's live rows (its ``alive`` mask at
    that tick), a prefill call's group."""
    calls = []
    original = port_engine.sample_tokens

    def sample(logits, temps, topks, seeds, counters):
        caller = sys._getframe(1).f_locals
        if "alive" in caller:
            rows = caller["alive"].numpy().copy()
        else:
            rows = np.zeros((len(temps),), bool)
            rows[caller["group"]] = True
        calls.append(([t.numpy().copy() for t in (logits, temps, topks,
                                                   seeds, counters)], rows))
        return original(logits, temps, topks, seeds, counters)

    monkeypatch.setattr(port_engine, "sample_tokens", sample)
    return calls


def _margin_checked(reqs_fn, monkeypatch, **eng_kw):
    """Serve on a fresh engine with the sampler recording; every kept
    decision must clear twice ``CHUNK_TOL``.  Returns the fingerprint."""
    calls = _recording_sampler(monkeypatch)
    got, _ = _serve(reqs_fn(), **eng_kw)
    monkeypatch.undo()
    for i, ((logits, temps, topks, seeds, counters), rows) in enumerate(
            calls):
        for b in np.flatnonzero(rows):
            _check_decision(logits[b], temps[b], topks[b], seeds[b],
                            counters[b], CHUNK_TOL,
                            context=f"call {i} row {b}")
    return got


_BASE = {}


def _baseline(kv_layout, kv_quant, temperature=0.0):
    key = (kv_layout, kv_quant, temperature)
    if key not in _BASE:
        _BASE[key], _ = _serve(_greedy(_mix(), temperature=temperature),
                               kv_layout=kv_layout, kv_quant=kv_quant)
    return _BASE[key]


# ---------------------------------------------------------------------------
# a window of n ticks ≡ n single ticks (bitwise)
# ---------------------------------------------------------------------------


def _clone(cache):
    return {k: ([{n: t.clone() for n, t in e.items()} for e in v]
                if isinstance(v, list) else v.clone())
            for k, v in cache.items()}


def test_fused_decode_window_is_its_single_ticks():
    """``make_fused_decode(n_ticks=3)`` against three one-tick calls on a
    cloned cache: the (3, B) tokens, counters, positions and every cache
    tensor equal; a row with budget 1 freezes after one token, and an idle
    row is inert throughout."""
    prefill, _ = port_engine.make_serve_fns(PCFG, max_len=32, kv_quant=True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, CFG.vocab_size, size=(3, 8))).long()
    lens = torch.tensor([8, 5, 6], dtype=torch.int32)
    off = torch.tensor([0, 100, 7], dtype=torch.int32)
    _, cache = prefill(TORCH_PARAMS, toks, lens, off)
    clone = _clone(cache)
    one = port_engine.make_fused_decode(PCFG, n_ticks=1)
    three = port_engine.make_fused_decode(PCFG, n_ticks=3)
    temps = torch.tensor([0.0, 0.8, 0.0])
    topks = torch.tensor([0, 40, 0], dtype=torch.int32)
    seeds = torch.tensor([1, 2, 3], dtype=torch.int32)
    counters = torch.tensor([7, 107, 9], dtype=torch.int32)
    token = torch.tensor([3, 4, 5], dtype=torch.int32)
    alive = torch.tensor([True, True, False])
    budgets = torch.tensor([3, 1, 0], dtype=torch.int32)
    stops = torch.full((3, 1), -1, dtype=torch.int32)
    got, last, ctr, new = three(TORCH_PARAMS, token, cache, off, 0, temps,
                                topks, seeds, counters, alive, budgets, stops)
    assert got.shape == (3, 3) and got.dtype == torch.int32

    want, t, c, a = [], token, counters, alive
    emitted = torch.zeros(3, dtype=torch.int32)
    for j in range(3):
        toks_j, t, c, clone = one(TORCH_PARAMS, t, clone, off, j, temps,
                                  topks, seeds, c, a, budgets, stops)
        want.append(toks_j[0])
        emitted += a.to(torch.int32)
        a = a & (emitted < budgets)
    assert torch.equal(got, torch.stack(want))
    assert torch.equal(last, t) and torch.equal(ctr, c)
    assert torch.equal(ctr, counters + torch.tensor([3, 1, 0]))
    assert torch.equal(new["pos"], lens + torch.tensor([3, 1, 0]))
    assert torch.equal(got[1:, 1], got[0, 1].repeat(2))
    assert torch.equal(got[:, 2], token[2].repeat(3))
    for e_got, e_want in zip(new["layers"], clone["layers"]):
        for name in e_got:
            assert torch.equal(e_got[name], e_want[name]), name


def test_fused_decode_stop_row_freezes_the_slot():
    """A slot whose sampled token is in its stop row emits it and then
    freezes: its later window entries repeat it, counter and position
    advance once."""
    cfg = PCFG
    prefill, _ = port_engine.make_serve_fns(cfg, max_len=32)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, CFG.vocab_size, size=(2, 8))).long()
    lens = torch.tensor([8, 6], dtype=torch.int32)
    off = torch.zeros(2, dtype=torch.int32)
    args = (torch.zeros(2), torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32))
    counters = torch.zeros(2, dtype=torch.int32)
    token = torch.tensor([3, 4], dtype=torch.int32)
    alive = torch.tensor([True, True])
    budgets = torch.tensor([4, 4], dtype=torch.int32)
    _, cache = prefill(TORCH_PARAMS, toks, lens, off)
    probe = port_engine.make_fused_decode(cfg, n_ticks=1)
    first, *_ = probe(TORCH_PARAMS, token, _clone(cache), off, 0, *args,
                      counters, alive, budgets,
                      torch.full((2, 1), -1, dtype=torch.int32))
    stops = torch.tensor([[int(first[0, 0]), -1], [-1, -1]],
                         dtype=torch.int32)
    got, _, ctr, new = port_engine.make_fused_decode(cfg, n_ticks=4)(
        TORCH_PARAMS, token, cache, off, 0, *args, counters, alive, budgets,
        stops)
    assert torch.equal(got[:, 0], first[0, 0].repeat(4))
    assert ctr.tolist() == [1, 4]
    assert torch.equal(new["pos"], lens + torch.tensor([1, 4]))


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kv_layout", ["ring", "paged"])
@pytest.mark.parametrize("n", [3, 4])
def test_fused_window_matches_single_ticks(kv_layout, kv_quant, n):
    got, eng = _serve(_greedy(_mix()), kv_layout=kv_layout,
                      kv_quant=kv_quant, decode_ticks=n)
    assert got == _baseline(kv_layout, kv_quant)
    assert eng.tick == n * eng.stats["decode_calls"]
    if eng.pool is not None:
        assert eng.pool_stats()["live"] == 0


@pytest.mark.parametrize("kv_layout", ["ring", "paged"])
def test_fused_window_bitwise_under_temperature(kv_layout):
    """Sampled streams too: the sampler hashes (seed, counter = offset +
    emitted), which the window advances as single ticks do."""
    got, _ = _serve(_greedy(_mix(), temperature=0.8), kv_layout=kv_layout,
                    decode_ticks=4)
    assert got == _baseline(kv_layout, False, temperature=0.8)


@pytest.mark.parametrize("num_blocks,preempted", [(12, 0), (5, 1)])
def test_fused_window_under_pool_pressure(num_blocks, preempted):
    """A pool too small for whole windows caps the per-window budgets
    (``_paged_cap``): streams equal the one-tick engine's; at 5 blocks
    requests are preempted with their blocks and resume."""
    want, _ = _serve(_greedy(_mix()), kv_layout="paged",
                     num_blocks=num_blocks)
    got, eng = _serve(_greedy(_mix()), kv_layout="paged",
                      num_blocks=num_blocks, decode_ticks=4)
    assert got == want
    assert eng.stats["preemptions"] >= preempted
    assert eng.pool_stats()["live"] == 0


@pytest.mark.parametrize("kv_layout", ["ring", "paged"])
def test_fused_window_bitwise_under_dither_policy(kv_layout):
    """Under ``QuantPolicy(scheme="dither", backend="auto")`` tick j of a
    window quantises with counter tick + j, the single tick's counter, so
    with every request admitted at tick 0 a window of 3 or 4 ticks gives
    the one-tick streams bit for bit (the prefix cache is off under this
    scheme, as the reference gates it)."""
    pol = QuantPolicy(scheme="dither", backend="auto")
    reqs = lambda: _greedy(_mix(4), temperature=0.8, max_new=5)  # noqa: E731
    want, _ = _serve(reqs(), batch=4, kv_layout=kv_layout, kv_quant=True,
                     policy=pol)
    for n in (3, 4):
        got, eng = _serve(reqs(), batch=4, kv_layout=kv_layout,
                          kv_quant=True, policy=pol, decode_ticks=n)
        assert got == want, n
        assert eng._graphs is None


def test_decode_ticks_and_prefill_chunk_validation():
    for kw in (dict(decode_ticks=0), dict(prefill_chunk=0),
               dict(prefill_chunk=-3)):
        with pytest.raises(ValueError):
            Engine(TORCH_PARAMS, PCFG, 2, 16, device="cpu", **kw)
    with pytest.raises(ValueError):
        port_engine.make_fused_decode(PCFG, n_ticks=0)


# ---------------------------------------------------------------------------
# the port's windows against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kv_layout", ["ring", "paged"])
def test_window_streams_equal_reference(kv_layout, kv_quant, monkeypatch):
    """The port at ``decode_ticks=4`` emits the reference's
    ``decode_ticks=4`` streams, request by request.  The reference's
    single-tick run checks every decision's margin against ``LOGIT_TOL``
    first, and its window gives the same streams (its bitwise window
    contract)."""
    if kv_layout == "ring":
        ref_one = _reference(23, "fcfs", kv_quant, monkeypatch)
        reqs, kw = (lambda mod: _requests(23, mod)), {}
        batch, max_len = 2, 64
    else:
        ref_one = _reference_paged(9, kv_quant, monkeypatch)[0]
        reqs = lambda mod: _stream_requests(9, mod)   # noqa: E731
        kw, batch, max_len = dict(kv_layout="paged", block_size=8), 2, 64
    ref_eng = ref_engine.Engine(PARAMS, CFG, batch=batch, max_len=max_len,
                                kv_quant=kv_quant, decode_ticks=4, **kw)
    for req in reqs(ref_engine):
        ref_eng.submit(req)
    ref_four = [(r.rid, r.finish_reason, r.out)
                for r in sorted(ref_eng.run(100), key=lambda r: r.rid)]
    assert ref_four == ref_one
    eng = Engine(TORCH_PARAMS, PCFG, batch, max_len, kv_quant=kv_quant,
                 decode_ticks=4, device="cpu", **kw)
    for req in reqs(port_engine):
        eng.submit(req)
    port = [(r.rid, r.finish_reason, r.out)
            for r in sorted(eng.run(100), key=lambda r: r.rid)]
    assert port == ref_four
    assert eng.stats["decode_calls"] == ref_eng.stats["decode_calls"]


# ---------------------------------------------------------------------------
# chunked ring prefill against the reference's
# ---------------------------------------------------------------------------


def _assert_bf16_ulps(got, want, n=1):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32)).astype(np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= n * ulp), np.abs(got - want).max()


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_prefill_chunked_matches_reference(kv_quant):
    """Three chunk waves of up to 6 tokens over rows of 16, 9 and 5
    prompt tokens (a row sits out its finished waves; the 12-slot ring
    wraps under the longest), from the same numpy-seeded tokens on both
    sides: logits within ``LOGIT_TOL``, ``pos`` and ``k_pos`` exact, the
    first layer's cache within one bf16 ulp or one int8 code."""
    rng = np.random.default_rng(3)
    full = rng.integers(1, CFG.vocab_size, size=(3, 16)).astype(np.int32)
    lens = np.array([16, 9, 5], np.int32)
    off = np.array([0, 1000, 2000], np.int32)
    jc = ref_registry.make_cache(PARAMS, CFG, 3, 12, kv_quant=kv_quant)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    eq = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    starts = np.zeros(3, np.int32)

    def port(cache):
        return registry.apply_prefill_chunked(
            TORCH_PARAMS, PCFG, torch.from_numpy(toks).long(),
            torch.from_numpy(clen), torch.from_numpy(starts), cache,
            kv_quant=kv_quant, kv_offset=torch.from_numpy(off))

    for _ in range(3):
        clen = np.minimum(6, lens - starts).astype(np.int32)
        toks = np.zeros((3, 8), np.int32)
        for b in range(3):
            toks[b, :clen[b]] = full[b, starts[b]:starts[b] + clen[b]]
        jl, jc = ref_registry.apply_prefill_chunked(
            PARAMS, CFG, jnp.asarray(toks), jnp.asarray(clen),
            jnp.asarray(starts), jc, kv_quant=kv_quant,
            kv_offset=jnp.asarray(off))
        tl, tc = port(tc)
        with reference_norm_and_rope():
            _, eq = port(eq)
        active = clen > 0
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], atol=LOGIT_TOL,
                                   rtol=0)
        assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        want = jax.tree.map(lambda t: np.asarray(t[0]), jc["layers"][0])
        got = {k: v[0] for k, v in eq["layers"][0].items()}
        assert np.array_equal(got["k_pos"].numpy(), want["k_pos"])
        for name in ("k", "v"):
            if kv_quant:
                d = np.abs(got[name].numpy().astype(int)
                           - want[name].astype(int))
                assert d.max() <= 1, name
            else:
                _assert_bf16_ulps(got[name], want[name])
        if kv_quant:
            for name in ("k_scale", "v_scale"):
                _assert_bf16_ulps(got[name], want[name])
        starts = starts + clen
    assert np.array_equal(starts, lens)


# ---------------------------------------------------------------------------
# chunked ≡ whole-prompt prefill
# ---------------------------------------------------------------------------


def _chunked_last_logits(layout, kv_quant, toks, lens, off, chunk):
    """Prefill ``toks`` (B, S) in chunks of ``chunk`` tokens through the
    ring's chunked prefill or the paged prefill's block-aligned suffix
    calls → each row's logits at its last prompt token."""
    b = toks.shape[0]
    kw = (dict(kv_layout="paged", block_size=BLOCK, num_blocks=b * 6)
          if layout == "paged" else {})
    cache = registry.make_cache(TORCH_PARAMS, PCFG, b, 48, kv_quant=kv_quant,
                                device="cpu", **kw)
    bt = torch.arange(b * 6, dtype=torch.int32).reshape(b, 6)
    starts = np.zeros(b, np.int32)
    last = [None] * b
    while (starts < lens).any():
        clen = np.minimum(chunk, lens - starts).astype(np.int32)
        piece = np.zeros((b, chunk), np.int64)
        for i in range(b):
            piece[i, :clen[i]] = toks[i, starts[i]:starts[i] + clen[i]]
        args = (torch.from_numpy(piece), torch.from_numpy(clen),
                torch.from_numpy(starts))
        if layout == "paged":
            logits, cache = registry.apply_prefill_paged(
                TORCH_PARAMS, PCFG, *args, bt, cache, kv_quant=kv_quant,
                kv_offset=off, prefix_blocks=6 if starts.any() else 0)
        else:
            logits, cache = registry.apply_prefill_chunked(
                TORCH_PARAMS, PCFG, *args, cache, kv_quant=kv_quant,
                kv_offset=off)
        for i in range(b):
            if clen[i] and starts[i] + clen[i] == lens[i]:
                last[i] = logits[i]
        starts = starts + clen
    return torch.stack(last)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("layout,chunks", [("ring", (2, 5, 16)),
                                           ("paged", (BLOCK, 2 * BLOCK))])
def test_chunked_logits_within_tolerance_of_whole_prompt(layout, chunks,
                                                         kv_quant):
    """Prompts of 21, 13 and 30 tokens prefilled in chunks: each row's
    last-chunk logits within ``CHUNK_TOL`` (max) and ``CHUNK_MEAN_TOL``
    (mean) of the whole-prompt prefill's — the drift the stream tests'
    margins allow for."""
    rng = np.random.default_rng(7)
    toks = rng.integers(1, CFG.vocab_size, size=(3, 32))
    lens = np.array([21, 13, 30], np.int32)
    off = torch.tensor([0, 500, 1000], dtype=torch.int32)
    whole, _ = registry.apply_prefill(
        TORCH_PARAMS, PCFG, torch.from_numpy(toks).long(),
        torch.from_numpy(lens), 48, kv_quant=kv_quant, kv_offset=off)
    for chunk in chunks:
        got = _chunked_last_logits(layout, kv_quant, toks, lens, off, chunk)
        d = (got - whole).abs()
        assert d.max().item() <= CHUNK_TOL, (chunk, d.max().item())
        assert d.mean().item() <= CHUNK_MEAN_TOL, (chunk, d.mean().item())


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kv_layout", ["ring", "paged"])
def test_chunked_prefill_matches_whole_prompt(kv_layout, kv_quant,
                                              monkeypatch):
    want = _margin_checked(lambda: _sampled(_mix(), 3), monkeypatch,
                           kv_layout=kv_layout, kv_quant=kv_quant)
    got, eng = _serve(_sampled(_mix(), 3), kv_layout=kv_layout,
                      kv_quant=kv_quant, prefill_chunk=5)
    assert got == want
    assert eng.stats["prefill_calls"] > len(_mix())   # it did chunk
    if eng.pool is not None:
        assert eng.pool_stats()["live"] == 0


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kv_layout", ["ring", "paged"])
def test_chunked_prefill_with_fused_windows(kv_layout, kv_quant,
                                            monkeypatch):
    """The whole overlapped configuration — chunks admitted between 4-tick
    windows — gives the unoverlapped engine's streams."""
    want = _margin_checked(lambda: _sampled(_mix(), 3), monkeypatch,
                           kv_layout=kv_layout, kv_quant=kv_quant)
    got, _ = _serve(_sampled(_mix(), 3), kv_layout=kv_layout,
                    kv_quant=kv_quant, prefill_chunk=5, decode_ticks=4)
    assert got == want


# ---------------------------------------------------------------------------
# chunk and block boundaries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_layout,chunk", [("ring", 5), ("paged", BLOCK)])
def test_prompt_lengths_straddling_boundaries(kv_layout, chunk, monkeypatch):
    """Prompt lengths at, one below and one above the chunk (and block)
    size and twice it: partial and full last chunks agree with
    whole-prompt prefill.  (Seed 6: seed 5 fails the margin check.)"""
    lens = sorted({chunk - 1, chunk, chunk + 1, 2 * chunk - 1, 2 * chunk,
                   2 * chunk + 1, 1})
    prompts = [[(23 * r + i) % (CFG.vocab_size - 1) + 1 for i in range(n)]
               for r, n in enumerate(lens)]
    want = _margin_checked(lambda: _sampled(prompts, 6), monkeypatch,
                           kv_layout=kv_layout)
    got, _ = _serve(_sampled(prompts, 6), kv_layout=kv_layout,
                    prefill_chunk=chunk)
    assert got == want


def test_empty_prompt_and_oversized_chunk(monkeypatch):
    """Empty prompts take the BOS substitution through the chunked path,
    and a chunk above ``max_len`` is clamped to the ring: both give the
    whole-prompt streams."""
    prompts = [[], [5, 6, 7], []]
    want = _margin_checked(lambda: _sampled(prompts, 0), monkeypatch)
    for chunk in (2, 10 ** 6):
        got, eng = _serve(_sampled(prompts, 0), prefill_chunk=chunk)
        assert got == want, chunk
        assert eng.prefill_chunk == min(chunk, 48)


def test_paged_chunk_rounds_to_block_multiple():
    eng = Engine(TORCH_PARAMS, PCFG, 2, 32, device="cpu", kv_layout="paged",
                 block_size=BLOCK, prefill_chunk=BLOCK + 3)
    assert eng.prefill_chunk == BLOCK                 # rounded down
    eng2 = Engine(TORCH_PARAMS, PCFG, 2, 32, device="cpu", kv_layout="paged",
                  block_size=BLOCK, prefill_chunk=1)
    assert eng2.prefill_chunk == BLOCK                # at least one block
    eng3 = Engine(TORCH_PARAMS, PCFG, 2, 32, device="cpu", prefill_chunk=40)
    assert eng3.prefill_chunk == 32                   # the ring's capacity


def test_prefix_hit_ending_mid_chunk():
    """A prefix hit hands the request a block-aligned start and leaves a
    suffix shorter than one chunk, so its only chunk is partial and rides
    the prefix join: the warm stream equals the cold one (both chunked,
    so the pool holds the same codes; bit for bit, greedy)."""
    p_long = [(3 * i) % (CFG.vocab_size - 1) + 1 for i in range(2 * BLOCK)]
    p_warm = p_long[:2 * BLOCK - 3] + [401, 402]
    cold, _ = _serve(_greedy([p_warm]), kv_layout="paged",
                     prefill_chunk=BLOCK)
    eng = Engine(TORCH_PARAMS, PCFG, 2, 48, device="cpu", kv_layout="paged",
                 block_size=BLOCK, prefill_chunk=BLOCK)
    eng.submit(Request(rid=5, prompt=p_long,
                       sampling=SamplingParams(max_new=6, counter_offset=0)))
    eng.run(100)
    eng.submit(_greedy([p_warm])[0])
    done = eng.run(200)
    warm = [d for d in done if d.rid == 0][0]
    assert eng.stats["prefix_hit_tokens"] >= BLOCK    # the hit happened
    assert (0, tuple(warm.out), warm.finish_reason) == cold[0]


def test_preempt_resume_half_prefilled():
    """White-box: preempt a request mid-prefill (``prefilling``, blocks
    intact) and let admission resume it: it rejoins the chunk waves at its
    ``_pf_pos`` and finishes with the undisturbed engine's stream."""
    prompts = _mix(3)
    prompts[0] = [(5 * i) % (CFG.vocab_size - 1) + 1
                  for i in range(4 * BLOCK)]
    want, _ = _serve(_greedy(prompts), kv_layout="paged",
                     prefill_chunk=BLOCK)
    eng = Engine(TORCH_PARAMS, PCFG, 2, 48, device="cpu", kv_layout="paged",
                 block_size=BLOCK, prefill_chunk=BLOCK)
    for req in _greedy(prompts):
        eng.submit(req)
    preempted = False
    for _ in range(400):
        if not preempted:
            for i, s in enumerate(eng.slots):
                if s is not None and s.state == "prefilling" \
                        and 0 < s._pf_pos < len(s.prompt):
                    eng._preempt_requeue(i, s)
                    preempted = True
                    break
        eng.step()
        if not len(eng.scheduler) and all(s is None for s in eng.slots):
            break
    assert preempted, "the fixture never caught a half-prefilled slot"
    got = sorted((d.rid, tuple(d.out), d.finish_reason) for d in eng.finished)
    assert got == want
    assert eng.stats["preemptions"] >= 1
    assert eng.pool_stats()["live"] == 0
