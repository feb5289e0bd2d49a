"""The port's paged ``Engine`` (``kv_layout="paged"``) at
``smollm_135m.reduced()``: its own contracts, as the reference's
``tests/test_paged_attention.py`` pins them for the reference — paged ≡
ring when the ring's cap is the block size, a prefix hit ≡ a cold prefill,
preemption resumes with its blocks intact, the deadlock breaker keeps the
engine live, a pool below the dense ring's size serves a full wave,
restarts replay, unservable requests are rejected — and its streams against
the reference's paged engine on the same weights.

The stream comparison uses ``tests/test_torch_serve.py``'s method: the
reference's logits differ from the port's by up to ``LOGIT_TOL`` (2⁻⁶),
so every sampling decision of the reference is first checked to clear
twice that margin (``_check_decision``); a fixture that fails the check is
reseeded, never loosened.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_serve import _check_decision

import repro.serve.engine as ref_engine
import repro_torch.serve.engine as port_engine
from repro.configs import get_config
from repro.models import registry as ref_registry
from repro_torch.configs import get_config as port_get_config
from repro_torch.interop import params_from_numpy
from repro_torch.serve import Engine, Request, SamplingParams
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = get_config("smollm_135m").reduced()
PCFG = port_get_config("smollm_135m").reduced()
PARAMS = ref_registry.init_model(jax.random.PRNGKey(0), CFG)
TORCH_PARAMS = params_from_numpy(jax.tree.map(np.asarray, PARAMS), "cpu")
LOGIT_TOL = 2.0 ** -6


def _prompts(seed, n, length):
    rng = np.random.default_rng(seed)
    return rng.integers(1, CFG.vocab_size, size=(n, length)).tolist()


def _serve(prompts, max_new, *, batch=None, max_len=32, **kw):
    eng = Engine(TORCH_PARAMS, PCFG, batch or len(prompts), max_len,
                 device="cpu", **kw)
    for r, p in enumerate(prompts):
        eng.submit(Request(rid=r, prompt=list(p), max_new=max_new))
    done = sorted(eng.run(60 + 40 * max_new), key=lambda r: r.rid)
    return eng, [r.out for r in done], [r.finish_reason for r in done]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_paged_engine_matches_ring_engine(kv_quant):
    """Cold paged serving emits exactly the ring engine's tokens, bit for
    bit: the ring cap equals the block size, so both layouts run one
    recurrence on the same tiles, and a cold paged prefill is the ring
    prefill's ops."""
    prompts = _prompts(0, 2, 5)
    _, ring, _ = _serve(prompts, 6, kv_quant=kv_quant)
    _, paged, _ = _serve(prompts, 6, kv_layout="paged", block_size=32,
                         kv_quant=kv_quant)
    assert paged == ring


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_prefix_hit_matches_cold_prefill(kv_quant):
    """A prefix-cache hit produces the same tokens as a cold prefill of the
    full prompt: the shared blocks hold exactly the codes a cold prefill
    writes (counter = absolute position), and the suffix attends them
    through the pool gather."""
    shared = _prompts(11, 1, 8)[0]                # 2 full blocks at bs=4

    def serve(prefix_cache):
        eng = Engine(TORCH_PARAMS, PCFG, 2, 32, device="cpu",
                     kv_layout="paged", block_size=4, kv_quant=kv_quant,
                     prefix_cache=prefix_cache)
        for r in range(4):
            eng.submit(Request(rid=r, prompt=shared + [10 + r, 30 + r],
                               max_new=5))
        return eng, [r.out for r in sorted(eng.run(100),
                                            key=lambda r: r.rid)]

    hit_eng, hit = serve(True)
    cold_eng, cold = serve(False)
    assert hit == cold
    assert hit_eng.stats["prefix_hit_tokens"] > 0
    assert hit_eng.pool_stats()["prefix_hit_blocks"] > 0
    assert cold_eng.stats["prefix_hit_tokens"] == 0


def test_paged_preemption_resumes_not_reprefills():
    """A starved pool preempts a request back through the scheduler with
    its blocks intact; the resumed stream equals unconstrained serial
    execution on the ring engine — nothing re-prefilled, nothing lost."""
    prompts = [[1 + r, 2, 3] for r in range(3)]
    eng, out, reasons = _serve(prompts, 8, batch=2, kv_layout="paged",
                               block_size=4, num_blocks=5,
                               prefix_cache=False)
    assert eng.stats["preemptions"] >= 1
    assert reasons == ["length"] * 3
    _, serial, _ = _serve(prompts, 8, batch=1)
    assert out == serial


def test_paged_deadlock_breaks_via_reprefill():
    """Every block held by preempted queued requests and nothing active:
    the engine flips victims to re-prefill and completes the wave.  A
    re-prefilled resume is rounding-equal, not bitwise, to the
    uninterrupted run, so this pins liveness and budget, as the reference
    does."""
    eng, out, reasons = _serve([[1, 2, 3], [2, 2, 3]], 10, max_len=16,
                               kv_layout="paged", block_size=4,
                               num_blocks=3, prefix_cache=False)
    assert [len(o) for o in out] == [10, 10]
    assert reasons == ["length", "length"]
    assert eng.stats["preemptions"] >= 2
    assert eng.pool.live_blocks == 0


def test_paged_pool_capacity_below_dense_ring():
    """A pool of 96 token slots serves a wave of four requests where the
    dense ring would hold 4 × 64 slots up front."""
    eng, out, _ = _serve([[1 + r, 2, 3, 4] for r in range(4)], 6,
                         max_len=64, kv_layout="paged", block_size=8,
                         num_blocks=12)
    assert len(out) == 4 and all(len(o) == 6 for o in out)
    assert eng.pool.live_blocks == 0            # all released on finish


def test_paged_restart_determinism():
    """The same submissions on a fresh paged engine reproduce every token:
    counters are position-keyed, block placement does not enter the
    math."""
    def run():
        eng = Engine(TORCH_PARAMS, PCFG, 2, 32, device="cpu",
                     kv_layout="paged", block_size=4, kv_quant=True)
        for r in range(4):
            eng.submit(Request(
                rid=r, prompt=[1 + r, 2, 3, 4, 5],
                sampling=SamplingParams(temperature=0.8, top_k=16, seed=r,
                                        max_new=5, counter_offset=100 * r)))
        return [(r.rid, tuple(r.out), r.finish_reason)
                for r in sorted(eng.run(80), key=lambda r: r.rid)]

    assert run() == run()


def test_paged_rejects_unservable_requests():
    eng = Engine(TORCH_PARAMS, PCFG, 1, 8, device="cpu", kv_layout="paged",
                 block_size=4, num_blocks=1)
    eng.submit(Request(rid=0, prompt=list(range(1, 20)), max_new=4))
    eng.submit(Request(rid=1, prompt=[1, 2, 3, 4, 5], max_new=4))  # > 1 block
    done = sorted(eng.run(20), key=lambda r: r.rid)
    assert [r.finish_reason for r in done] == ["rejected", "rejected"]


def test_copy_on_write_copies_the_device_block():
    """The copy-on-write guard: when the block a decode write would land in
    has another holder, the engine takes a private block, copies every
    layer's K, V and scales into it on the device, points the slot's table
    at it, and the stream goes on unchanged."""
    def serve(share_tail):
        eng = Engine(TORCH_PARAMS, PCFG, 1, 32, device="cpu",
                     kv_layout="paged", block_size=4, kv_quant=True)
        eng.submit(Request(rid=0, prompt=[5, 6, 7, 8, 9, 10], max_new=4))
        eng.step()                                # prefill + first decode
        if share_tail:
            tail = eng.pool.table(0)[-1]
            eng.pool._ref[tail] += 1              # a second holder appears
            eng._ensure_tail_writable(0, eng.slots[0], 1)
            fresh = eng.pool.table(0)[-1]
            assert fresh != tail and eng._bt[0, 1] == fresh
            assert eng.pool.stats["cow_copies"] == 1
            for entry in eng.cache["layers"]:
                for t in entry.values():
                    assert torch.equal(t[:, fresh], t[:, tail])
        return [r.out for r in eng.run(20)]

    assert serve(True) == serve(False)


# ---------------------------------------------------------------------------
# streams against the reference's paged engine
# ---------------------------------------------------------------------------

BATCH, MAX_LEN, BLOCK = 2, 64, 8
# (temperature, top_k, max_new, counter_offset) by rid.  Rids 0 and 2 share
# a counter offset, as do 1 and 3, so under int8 too the later request of
# each pair can hit the earlier one's sealed blocks of the shared prompt
SAMPLING = [(0.0, 0, 2, 0), (0.8, 0, 5, 1000), (0.8, 40, 3, 0),
            (0.0, 0, 3, 1000)]


def _stream_requests(seed, mod):
    """A shared 16-token system prompt (two blocks), then a per-request
    suffix of 3..10 tokens."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, CFG.vocab_size, size=2 * BLOCK).tolist()
    reqs = []
    for r, (temp, top_k, max_new, off) in enumerate(SAMPLING):
        suffix = rng.integers(1, CFG.vocab_size,
                              size=int(rng.integers(3, 11))).tolist()
        sp = mod.SamplingParams(temperature=temp, top_k=top_k, seed=seed + r,
                                max_new=max_new, counter_offset=off)
        reqs.append(mod.Request(rid=r, prompt=system + suffix, sampling=sp))
    return reqs


def _reference_paged(seed, kv_quant, monkeypatch):
    """The reference's paged engine with its sampler recording every call;
    every deciding row's margin is checked.  Returns the streams and the
    engine's prefix-hit and preemption counts."""
    calls, holder = [], {}

    def record(*arrays):
        slots = holder["engine"].slots
        fresh = any(s is not None and not s.out for s in slots)
        decide = [s is not None and (not s.out if fresh else True)
                  for s in slots]
        calls.append(([np.array(a) for a in arrays], decide))

    def sample(*args):
        jax.debug.callback(record, *args)
        return original(*args)

    original = ref_engine.sample_tokens
    monkeypatch.setattr(ref_engine, "sample_tokens", sample)
    holder["engine"] = eng = ref_engine.Engine(
        PARAMS, CFG, batch=BATCH, max_len=MAX_LEN, kv_quant=kv_quant,
        kv_layout="paged", block_size=BLOCK)
    for req in _stream_requests(seed, ref_engine):
        eng.submit(req)
    done = sorted(eng.run(100), key=lambda r: r.rid)
    monkeypatch.undo()
    decisions = 0
    for i, ((logits, temps, topks, seeds, counters), decide) in enumerate(
            calls):
        for b in np.flatnonzero(decide):
            decisions += 1
            _check_decision(logits[b], temps[b], topks[b], seeds[b],
                            counters[b], LOGIT_TOL,
                            context=f"call {i} row {b}")
    assert decisions == sum(row[2] for row in SAMPLING)
    return ([(r.rid, r.finish_reason, r.out) for r in done],
            eng.stats["prefix_hit_tokens"], eng.stats["preemptions"])


@pytest.mark.parametrize("kv_quant,seed", [(False, 9), (True, 9)],
                         ids=["bf16", "int8"])
def test_paged_streams_equal_reference(kv_quant, seed, monkeypatch):
    """Greedy and temperature streams of the port's paged engine equal the
    reference paged engine's, request by request, with prefix hits on the
    shared system prompt, on margin-checked fixtures."""
    ref, ref_hits, ref_preempt = _reference_paged(seed, kv_quant, monkeypatch)
    eng = port_engine.Engine(TORCH_PARAMS, PCFG, BATCH, MAX_LEN,
                             kv_quant=kv_quant, kv_layout="paged",
                             block_size=BLOCK, device="cpu")
    for req in _stream_requests(seed, port_engine):
        eng.submit(req)
    port = [(r.rid, r.finish_reason, r.out)
            for r in sorted(eng.run(100), key=lambda r: r.rid)]
    assert port == ref
    assert all(reason == "length" and len(out) == SAMPLING[rid][2]
               for rid, reason, out in port)
    assert eng.stats["prefix_hit_tokens"] == ref_hits > 0
    assert eng.stats["preemptions"] == ref_preempt
    assert eng.pool.live_blocks == 0


def test_launcher_serves_paged_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --kv-layout paged`` on the
    reduced model, on the CPU: every request finishes with its budget, and
    the summary reports prefix hits and preemptions."""
    from repro_torch.launch.serve import serve_main

    serve_main(["--arch", "smollm_135m", "--reduced", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--max-new", "3",
                "--max-len", "32", "--kv-quant", "--kv-layout", "paged",
                "--block-size", "8", "--num-blocks", "6"])
    out = capsys.readouterr().out
    assert out.count("[length]") == 3
    assert "served 3/3 requests" in out
    assert "prefix_hit_tokens=" in out and "preemptions=" in out
