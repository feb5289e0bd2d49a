"""The port's speculative ``Engine`` (``spec_decode=True``) at
``smollm_135m.reduced()``: the reference's contracts for it, as
``tests/test_spec_decode.py`` pins them for the reference — the stream is
bit for bit the plain engine's over ring/paged × bf16/int8 × greedy and
temperature sampling; an all-accepting and an all-rejecting drafter commit
full windows and one token per window; every window's rollback leaves the
cache bytes and the pool state of an engine that never drafted; the
gates refuse what would break the contract — plus the port's own copy of
the drafters against the reference's, its streams against the reference
spec engine's on the same weights, and the launcher.

The comparison with the reference uses ``tests/test_torch_serve.py``'s
method: the two sides' logits differ by up to 2⁻⁶, so every sampling
decision of the reference (plain engine) is first checked to clear twice
that margin; the reference's spec stream must equal its plain stream (its
own contract), and the port's spec stream must equal both.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_paged_serve import _reference_paged, _stream_requests
from test_torch_serve import _reference, _requests

import repro.serve.engine as ref_engine
import repro_torch.serve.engine as port_engine
from repro.configs import get_config
from repro.models import registry as ref_registry
from repro.serve import draft as ref_draft
from repro_torch.configs import get_config as port_get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import registry
from repro_torch.serve import Engine, Request, SamplingParams
from repro_torch.serve import draft
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = get_config("smollm_135m").reduced()
PCFG = port_get_config("smollm_135m").reduced()
PARAMS = ref_registry.init_model(jax.random.PRNGKey(0), CFG)
TORCH_PARAMS = params_from_numpy(jax.tree.map(np.asarray, PARAMS), "cpu")


def _prompts(n, length=6):
    return [[(7 * r + i) % (CFG.vocab_size - 1) + 1 for i in range(length)]
            for r in range(n)]


class AntiReplayDrafter(draft.Drafter):
    """Proposes the wrong token at every position (the recorded stream's,
    shifted by one in the vocabulary): every window commits exactly row 0,
    so every window exercises the scrub and the truncation."""

    def __init__(self, streams):
        self.replay = draft.ReplayDrafter(streams)

    def propose(self, context, k):
        return [(t + 1) % CFG.vocab_size
                for t in self.replay.propose(context, k)]


def _engine(*, spec, drafter=None, kv_layout="ring", kv_quant=False,
            max_len=32, batch=2, draft_k=4):
    kw = dict(kv_layout="paged", block_size=4) if kv_layout == "paged" else {}
    return Engine(TORCH_PARAMS, PCFG, batch, max_len, kv_quant=kv_quant,
                  spec_decode=spec, draft_k=draft_k, drafter=drafter,
                  device="cpu", **kw)


def _submit(eng, requests=2, temperature=0.0, max_new=8):
    for r, p in enumerate(_prompts(requests)):
        eng.submit(Request(rid=r, prompt=p, sampling=SamplingParams(
            temperature=temperature, top_k=8 if temperature else 0, seed=r,
            max_new=max_new, counter_offset=1000 * r)))


def _serve(*, spec, drafter=None, kv_layout="ring", kv_quant=False,
           temperature=0.0, max_new=8, requests=2):
    eng = _engine(spec=spec, drafter=drafter, kv_layout=kv_layout,
                  kv_quant=kv_quant)
    _submit(eng, requests, temperature, max_new)
    done = eng.run(requests * (max_new + 6) + 20)
    return {r.rid: list(r.out) for r in done}, eng


# ---------------------------------------------------------------------------
# speculation changes when tokens are computed, never which
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "temp"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kv_layout", ["ring", "paged"])
def test_spec_stream_bitwise_equals_plain(kv_layout, kv_quant, temperature):
    """Prompt-lookup drafting over the whole grid: the spec stream is the
    plain stream, token for token, and every token after each request's
    prefill-emitted first one came through a spec window."""
    plain, _ = _serve(spec=False, kv_layout=kv_layout, kv_quant=kv_quant,
                      temperature=temperature)
    spec, eng = _serve(spec=True, kv_layout=kv_layout, kv_quant=kv_quant,
                       temperature=temperature)
    assert spec == plain
    st = eng.stats
    assert st["spec_windows"] == st["decode_calls"] > 0
    assert st["spec_emitted_tokens"] == st["decode_tokens"] == sum(
        len(o) - 1 for o in spec.values())


@pytest.mark.parametrize("kv_layout", ["ring", "paged"])
def test_accept_all_edge_commits_full_windows(kv_layout):
    """Replay drafting: every draft matches, so every window commits its
    whole budget — 7 post-prefill tokens per request in windows of 4 then
    3, two windows in all."""
    plain, _ = _serve(spec=False, kv_layout=kv_layout)
    streams = {tuple(p): plain[r] for r, p in enumerate(_prompts(2))}
    spec, eng = _serve(spec=True, drafter=draft.ReplayDrafter(streams),
                       kv_layout=kv_layout)
    assert spec == plain
    st = eng.stats
    assert st["spec_accepted_tokens"] == st["spec_draft_tokens"] > 0
    assert st["spec_windows"] == 2
    assert st["spec_emitted_tokens"] == 14


@pytest.mark.parametrize("kv_layout", ["ring", "paged"])
def test_reject_every_position_edge_still_progresses(kv_layout):
    """Anti-replay drafting: every draft is wrong, so every window commits
    exactly row 0 — plain decode's tick: 7 windows for the 14 tokens."""
    plain, _ = _serve(spec=False, kv_layout=kv_layout)
    streams = {tuple(p): plain[r] for r, p in enumerate(_prompts(2))}
    spec, eng = _serve(spec=True, drafter=AntiReplayDrafter(streams),
                       kv_layout=kv_layout)
    assert spec == plain
    st = eng.stats
    assert st["spec_accepted_tokens"] == 0 < st["spec_draft_tokens"]
    assert st["spec_windows"] == 7
    assert st["spec_emitted_tokens"] == 14


def test_empty_and_short_proposals_pad_safely():
    """A drafter may propose fewer than draft_k - 1 tokens: the window pads
    with zeros, scores them anyway, and the stream is still the plain
    one."""
    plain, _ = _serve(spec=False)
    spec, _ = _serve(spec=True, drafter=draft.FixedDrafter([3]))
    assert spec == plain
    spec, _ = _serve(spec=True, drafter=AntiReplayDrafter({}))   # proposes []
    assert spec == plain


# ---------------------------------------------------------------------------
# rejected-suffix rollback: cache bytes and pool state ≡ never drafted
# ---------------------------------------------------------------------------


def _lockstep(kv_layout, kv_quant=False, max_new=10):
    """A spec engine whose drafts all reject (one token per window) and a
    plain engine, at full batch occupancy (dead ring rows differ: plain
    decode writes junk into them, the verify write gate drops it)."""
    plain, _ = _serve(spec=False, kv_layout=kv_layout, kv_quant=kv_quant,
                      max_new=max_new)
    streams = {tuple(p): plain[r] for r, p in enumerate(_prompts(2))}
    engines = []
    for spec in (True, False):
        eng = _engine(spec=spec, kv_layout=kv_layout, kv_quant=kv_quant,
                      drafter=AntiReplayDrafter(streams) if spec else None)
        _submit(eng, max_new=max_new)
        engines.append(eng)
    return engines


def _cache_leaves(cache):
    out = []
    for entry in cache["layers"] + cache["remainder"]:
        out += [entry[k] for k in sorted(entry)]
    return out


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_rollback_ring_cache_bytes_equal_never_drafted(kv_quant):
    """After every window of an all-reject run, the ring cache is byte for
    byte the never-drafted engine's at the same position: the commit
    scrub restores rejected draft slots to never-written bytes (zero
    codes and scales, k_pos -1), and the accepted bytes need no touch-up
    (the dither codes are position-pure)."""
    spec, plain = _lockstep("ring", kv_quant)
    for _ in range(12):
        spec.step()
        plain.step()
        assert list(spec._slot_pos) == list(plain._slot_pos)
        assert torch.equal(spec.cache["pos"], plain.cache["pos"])
        for a, b in zip(_cache_leaves(spec.cache), _cache_leaves(plain.cache)):
            assert torch.equal(a, b)


def _readable_pool_bytes(eng):
    """Pool bytes a request can read: per slot, its table's blocks at
    positions below its ``_slot_pos`` (the rest are write targets; the
    paged prefill leaves pad junk in a partial block's tail, which the
    verify overwrites and the scrub blanks)."""
    bs = eng.block_size
    out = []
    for leaf in _cache_leaves(eng.cache):
        for i, req in enumerate(eng.slots):
            if req is None:
                continue
            n = int(eng._slot_pos[i])
            for j, phys in enumerate(eng.pool.table(req.rid)):
                out.append(leaf[:, phys, : max(0, min(bs, n - j * bs))])
    return out


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_rollback_paged_pool_state_equal_never_drafted(kv_quant):
    """Paged all-reject run: after every window the pool's refcounts, free
    list (order included: ``truncate`` in reverse slot order undoes the
    window's ``append_block``s), tables and prefix index equal the
    never-drafted engine's, and every readable pool byte is equal."""
    spec, plain = _lockstep("paged", kv_quant)
    for _ in range(12):
        spec.step()
        plain.step()
        assert list(spec._slot_pos) == list(plain._slot_pos)
        ps, pp = spec.pool, plain.pool
        assert ps._ref == pp._ref
        assert ps._free == pp._free
        assert list(ps._cached) == list(pp._cached)
        assert ps._tables == pp._tables
        assert np.array_equal(spec._bt, plain._bt)
        for a, b in zip(_readable_pool_bytes(spec),
                        _readable_pool_bytes(plain)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# gates: what speculation must refuse, raising as the reference does
# ---------------------------------------------------------------------------


class _Policy:
    enabled = True


@pytest.mark.parametrize("gate", ["draft_k", "policy", "window", "moe"])
def test_spec_gates_refuse(gate):
    """draft_k < 2; an enabled matmul policy (its tensor-global absmax
    couples verify rows); a ring smaller than max_len (verify rows would
    overwrite positions earlier rows attend); a family without a verify
    form (MoE: capacity ranks couple a row to its own drafts).  Each
    raises ValueError, as the reference's engine does, on both sides."""
    cfg, kw = PCFG, {}
    if gate == "draft_k":
        kw = dict(draft_k=1)
    elif gate == "policy":
        kw = dict(policy=_Policy())
    elif gate == "window":
        cfg = dataclasses.replace(PCFG, window=8)
    else:
        cfg = dataclasses.replace(PCFG, family="moe", n_experts=4,
                                  n_experts_active=2)
        assert not registry.supports_spec_decode(cfg)
    with pytest.raises(ValueError):
        Engine(TORCH_PARAMS, cfg, 2, 32, spec_decode=True, device="cpu", **kw)
    assert Engine(TORCH_PARAMS, PCFG, 2, 32, kv_layout="paged", block_size=4,
                  spec_decode=True, device="cpu").spec_decode


# ---------------------------------------------------------------------------
# the port's drafters, the reference's streams, the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["lookup", "replay", "fixed"])
def test_drafters_propose_what_the_reference_proposes(name):
    """The port's own copy of ``serve/draft.py`` proposes, on seeded
    contexts with repeats, exactly what the reference's drafters do."""
    rng = np.random.default_rng(3)
    contexts = [rng.integers(1, 9, size=int(n)).tolist()
                for n in rng.integers(0, 40, size=60)]
    streams = {tuple(c[:5]): rng.integers(1, 9, size=12).tolist()
               for c in contexts if len(c) >= 5}
    make = {"lookup": lambda m: m.PromptLookupDrafter(max_ngram=3),
            "replay": lambda m: m.ReplayDrafter(streams),
            "fixed": lambda m: m.FixedDrafter([4, 7, 1])}[name]
    port, ref = make(draft), make(ref_draft)
    for c in contexts:
        for k in (1, 3, 7):
            ctx = c + (streams.get(tuple(c[:5]), [])[:3] if name == "replay"
                       else [])
            assert port.propose(ctx, k) == ref.propose(ctx, k)


def _spec_reference(requests, **kw):
    """The reference spec engine's streams on the given requests."""
    eng = ref_engine.Engine(PARAMS, CFG, spec_decode=True, draft_k=4, **kw)
    for req in requests:
        eng.submit(req)
    return [(r.rid, r.finish_reason, r.out)
            for r in sorted(eng.run(100), key=lambda r: r.rid)]


def _spec_port(requests, drafter, **kw):
    eng = port_engine.Engine(TORCH_PARAMS, PCFG, spec_decode=True, draft_k=4,
                             drafter=drafter, device="cpu", **kw)
    for req in requests:
        eng.submit(req)
    done = sorted(eng.run(100), key=lambda r: r.rid)
    return [(r.rid, r.finish_reason, r.out) for r in done], eng


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_spec_streams_equal_reference_spec_engine(kv_quant, monkeypatch):
    """On ``tests/test_torch_serve.py``'s margin-checked ring fixture, the
    reference's spec stream equals its plain stream, and the port's spec
    stream (replay drafting of that stream, so windows accept) equals
    both."""
    seed, batch, max_len = 23, 2, 64
    plain = _reference(seed, "fcfs", kv_quant, monkeypatch)
    streams = {tuple(r.prompt): out for r, (_, _, out) in
               zip(_requests(seed, ref_engine), plain)}
    ref = _spec_reference(_requests(seed, ref_engine), batch=batch,
                          max_len=max_len, kv_quant=kv_quant,
                          drafter=ref_draft.ReplayDrafter(streams))
    assert ref == plain
    port, eng = _spec_port(_requests(seed, port_engine),
                           draft.ReplayDrafter(streams), batch=batch,
                           max_len=max_len, kv_quant=kv_quant)
    assert port == plain
    assert eng.stats["spec_accepted_tokens"] > 0


def test_paged_spec_streams_equal_reference_spec_engine(monkeypatch):
    """The same on ``tests/test_torch_paged_serve.py``'s margin-checked
    paged fixture (int8, prefix hits on a shared system prompt), with the
    default prompt-lookup drafter on both sides."""
    seed, kw = 9, dict(batch=2, max_len=64, kv_quant=True,
                       kv_layout="paged", block_size=8)
    plain, _, _ = _reference_paged(seed, True, monkeypatch)
    ref = _spec_reference(_stream_requests(seed, ref_engine), **kw)
    assert ref == plain
    port, eng = _spec_port(_stream_requests(seed, port_engine), None, **kw)
    assert port == plain
    assert eng.stats["prefix_hit_tokens"] > 0
    assert eng.pool.live_blocks == 0


@pytest.mark.parametrize("kv_layout", ["ring", "paged"])
def test_launcher_serves_spec_on_cpu(kv_layout, capsys):
    """``python -m repro_torch.launch.serve --spec-decode`` on the reduced
    model, on the CPU: every request finishes with its budget, and the
    summary reports the windows and the acceptance."""
    from repro_torch.launch.serve import serve_main

    args = ["--arch", "smollm_135m", "--reduced", "--device", "cpu",
            "--requests", "3", "--batch", "2", "--max-new", "6",
            "--spec-decode", "--draft-k", "4", "--kv-layout", kv_layout]
    if kv_layout == "paged":
        args += ["--max-len", "32", "--block-size", "8", "--kv-quant"]
    serve_main(args)
    out = capsys.readouterr().out
    assert out.count("[length]") == 3
    assert "served 3/3 requests" in out
    assert "spec-decode: k=4 windows=" in out and "accept_rate=" in out
