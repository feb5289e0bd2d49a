"""The port's serve-path fault tolerance (DESIGN.md §12) at
``smollm_135m.reduced()`` on the CPU: deadlines, shedding, degradation
and crash recovery, the reference's pins of ``tests/test_serve_fault.py``
re-pinned on the port's engine, plus what those pins lack.

The load-bearing pin is the **chaos recovery contract**: an engine crashed
at any of its five ``FailureInjector`` points and restored from its
snapshot emits streams equal, bit for bit, to an uninterrupted run — ring
and paged × bf16 and int8 × greedy and sampled — with no slot or block
leaked.  Beyond the reference's pins: a restore is also checked byte for
byte on the cache (``Engine.written_kv``: every written position of every
slot and queued block holder), and the cases the reference's fixtures
never reach are pinned — chunks in flight, prefix hits, preempted block
holders, prefix-cached blocks nobody holds.  Deadlines are driven through
the engine's clock ``_now``, never by waiting.  A fault of the
reference's restore the port does not share is pinned on both packages:
its replay steps a recurrent row that is out of tokens on token 0.

Cross-package: a snapshot the reference's engine writes mid-flight,
restored into the port's engine on the same weights, finishes with the
reference's uninterrupted streams, on the margin-checked fixtures of
``tests/test_torch_serve.py`` and ``tests/test_torch_paged_serve.py``
(``conftest.assert_argmax_margin`` at twice the 2⁻⁶ logit tolerance).
"""

import gc
import json
import weakref

import jax
import numpy as np
import pytest
from test_torch_paged_serve import _reference_paged, _stream_requests
from test_torch_serve import _reference, _requests

import repro.serve.engine as ref_engine
import repro_torch.serve.engine as port_engine
from repro.configs import get_config as ref_get_config
from repro.models import registry as ref_registry
from repro_torch.configs import get_config
from repro_torch.dist.fault_tolerance import (SERVE_PHASES, FailureInjector,
                                              InjectedFailure,
                                              StragglerWatchdog,
                                              run_serve_with_restarts,
                                              run_with_restarts)
from repro_torch.interop import params_from_numpy
from repro_torch.models import registry
from repro_torch.serve import Engine, Request, SamplingParams
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = get_config("smollm_135m").reduced()
PARAMS = registry.init_model(CFG, seed=0, device="cpu")
MAX_LEN = 32
EOS = 11

CONFIGS = {
    "ring-bf16": dict(decode_ticks=2),
    "ring-int8": dict(decode_ticks=2, kv_quant=True),
    "paged-bf16": dict(kv_layout="paged", block_size=8, decode_ticks=2),
    "paged-int8": dict(kv_layout="paged", block_size=8, decode_ticks=2,
                       kv_quant=True),
}
SYSTEM = [(5 * i + 3) % (CFG.vocab_size - 1) + 1 for i in range(8)]


def _request(rid, key=None, temperature=0.0, max_new=5, prompt_len=None,
             system=False, **kw):
    """A request whose content is a pure function of ``key``; with
    ``system`` its prompt starts with the shared 8-token ``SYSTEM``
    prefix (one block of 8, or two of 4)."""
    key = rid if key is None else key
    prompt_len = 4 + key % 3 if prompt_len is None else prompt_len
    prompt = [(7 * key + i) % (CFG.vocab_size - 1) + 1
              for i in range(prompt_len)]
    if system:
        prompt = SYSTEM + prompt
    return Request(rid=rid, prompt=prompt, priority=key % 2,
                   sampling=SamplingParams(temperature=temperature, seed=key,
                                           max_new=max_new, eos_id=EOS,
                                           counter_offset=0 if system
                                           else 100 * key), **kw)


def _engine(name=None, **kw):
    knobs = dict(CONFIGS[name]) if name else {}
    knobs.update(kw)
    return Engine(PARAMS, CFG, 2, MAX_LEN, device="cpu", **knobs)


def _streams(engine):
    return {r.rid: (list(r.out), r.finish_reason) for r in engine.finished}


def _serve(reqs, **kw):
    eng = _engine(**kw)
    for r in reqs:
        eng.submit(r)
    eng.run(300)
    return eng


def _assert_no_leaks(engine):
    assert all(s is None for s in engine.slots)
    assert len(engine.scheduler) == 0
    if engine.pool is not None:
        assert engine.pool.live_blocks == 0


def _assert_fcfs_within_priority(reqs):
    for prio in {r.priority for r in reqs}:
        admits = [r.t_admit for r in reqs
                  if r.priority == prio and r.t_admit is not None]
        assert admits == sorted(admits)


# -------------------------------------------------------------- deadlines


def test_deadline_expires_queued_request():
    """A queued request past its deadline finishes 'deadline' without ever
    reaching a slot; the expiry scan runs before admission."""
    eng = _engine("ring-bf16")
    eng.submit(_request(0, max_new=6))
    eng.submit(_request(1, max_new=6))
    expired = _request(2, deadline_s=30.0)
    eng.submit(expired)
    eng.step()
    clock = eng._now
    eng._now = lambda: clock() + 60.0
    eng.run(200)
    assert expired.finish_reason == "deadline"
    assert expired.out == [] and expired.t_admit is None
    assert eng.metrics.counters["finish_deadline"] == 1
    _assert_no_leaks(eng)


def test_queue_ttl_expires_stale_queue():
    eng = Engine(PARAMS, CFG, 1, MAX_LEN, queue_ttl_s=30.0, device="cpu")
    eng.submit(_request(0, max_new=4))
    eng.submit(_request(1, max_new=4))
    eng.step()                                  # admits rid 0; rid 1 queued
    clock = eng._now
    eng._now = lambda: clock() + 60.0           # everything is now stale
    done = {r.rid: r for r in eng.run(200)}
    assert done[1].finish_reason == "deadline" and done[1].out == []
    # the running request has no deadline_s: TTL only bounds queue wait
    assert done[0].finish_reason == "length"
    _assert_no_leaks(eng)


def test_deadline_cancels_running_request_and_releases_blocks():
    eng = _engine("paged-bf16")
    victim = _request(0, deadline_s=1e6, max_new=30)
    eng.submit(victim)
    eng.submit(_request(1, max_new=4))
    for _ in range(2):
        eng.step()
    assert victim.state == "active" and victim.out
    clock = eng._now
    eng._now = lambda: clock() + 2e6
    eng.run(200)
    assert victim.finish_reason == "deadline" and 0 < len(victim.out) < 30
    _assert_no_leaks(eng)


def test_deadline_expires_a_preempted_block_holder():
    """A request preempted with its blocks and then expired in the queue
    gives its blocks back."""
    eng = _engine(kv_layout="paged", block_size=4, num_blocks=5,
                  prefix_cache=False)
    reqs = [_request(r, max_new=12, prompt_len=6, deadline_s=1e6)
            for r in range(2)]
    for r in reqs:
        eng.submit(r)
    for _ in range(40):
        eng.step()
        held = [r for r in eng.scheduler.queued() if r._resume is not None]
        if held:
            break
    assert held, "the fixture must preempt a request with its blocks"
    clock = eng._now
    eng._now = lambda: clock() + 2e6
    eng.run(200)
    assert {r.finish_reason for r in reqs} == {"deadline"}
    _assert_no_leaks(eng)


# --------------------------------------------------------------- shedding


def test_shed_reject_new_bounds_the_queue():
    eng = Engine(PARAMS, CFG, 1, MAX_LEN, queue_cap=2, device="cpu")
    eng.submit(_request(0, max_new=6))
    eng.step()
    kept = [_request(1), _request(2)]
    for r in kept:
        eng.submit(r)
    shed = _request(3)
    eng.submit(shed)
    assert shed.done and shed.finish_reason == "shed" and shed.out == []
    assert shed in eng.finished and len(eng.scheduler) == 2
    eng.run(300)
    assert all(r.finish_reason in ("length", "eos") for r in kept)
    assert eng.metrics.counters["finish_shed"] == 1
    assert eng.metrics.counters["finished_requests"] == 4
    _assert_no_leaks(eng)


def test_shed_evict_lowest_priority_prefers_newcomer_rank():
    eng = Engine(PARAMS, CFG, 1, MAX_LEN, queue_cap=2, device="cpu",
                 shed_policy="evict-lowest-priority", scheduler="priority")
    eng.submit(_request(0, max_new=6))
    eng.step()
    low_old, low_new = _request(1), _request(2)
    for r in (low_old, low_new):
        r.priority = 0
        eng.submit(r)
    vip = _request(3)
    vip.priority = 5
    eng.submit(vip)           # evicts the lowest-priority *latest* arrival
    assert low_new.finish_reason == "shed"
    assert not low_old.done and not vip.done
    peer = _request(4)
    peer.priority = 0         # does not outrank the queue minimum
    eng.submit(peer)
    assert peer.finish_reason == "shed"
    eng.run(300)
    assert {r.rid for r in eng.finished} == {0, 1, 2, 3, 4}
    assert eng.metrics.counters["finish_shed"] == 2
    _assert_no_leaks(eng)


def test_knob_checks_match_the_reference():
    for kw in (dict(shed_policy="drop-all"), dict(queue_cap=0),
               dict(degrade_low=0.95, degrade_high=0.9),
               dict(degrade_high=1.5), dict(degrade_low=0.0)):
        with pytest.raises(ValueError):
            _engine(**kw)
    # the mesh is ported (item 10): a data axis that does not divide the
    # batch raises ValueError, as the reference's does
    from repro_torch.dist.sharding import MeshShape
    with pytest.raises(ValueError, match="multiple of the mesh's data axis"):
        _engine(mesh=MeshShape(("data", "model"), (4, 1)))
    # frames are ported (item 11b-ii); a decoder-only engine ignores them,
    # as the reference's does
    assert _engine(frames=object())._frames is None


# ------------------------------------------------------------ degradation


def test_degradation_watermarks_have_hysteresis():
    eng = _engine(kv_layout="paged", block_size=4, num_blocks=8,
                  decode_ticks=4)
    pool, bs = eng.pool, 4
    assert eng._window_ticks() == 4
    pool.allocate(999, 8 * bs)                       # live share 1.0
    eng._update_pressure()
    assert eng._degraded and eng._window_ticks() == 1
    pool.release(999)
    pool.allocate(998, 7 * bs)                       # 0.875: between marks
    eng._update_pressure()
    assert eng._degraded, "must stay degraded between the watermarks"
    pool.release(998)
    pool.allocate(997, 4 * bs)                       # 0.5 <= degrade_low
    eng._update_pressure()
    assert not eng._degraded and eng._window_ticks() == 4
    pool.allocate(996, 3 * bs)                       # 0.875, from below
    eng._update_pressure()
    assert not eng._degraded, "must stay clear until the high watermark"
    assert eng.metrics.counters["degrade_events"] == 1


def test_degradation_off_never_steps_down():
    """``degrade_high=None`` (a port knob the reference lacks) turns
    degradation off: a full pool keeps the window and sealing."""
    eng = _engine(kv_layout="paged", block_size=4, num_blocks=8,
                  decode_ticks=4, degrade_high=None)
    eng.pool.allocate(999, 8 * 4)                    # live share 1.0
    eng._update_pressure()
    assert not eng._degraded and eng._window_ticks() == 4
    assert "degrade_events" not in eng.metrics.counters


def test_degraded_engine_streams_are_unchanged():
    """A forced-degraded run (single-tick windows, no prefix insertion)
    emits a normal run's tokens."""
    reqs = lambda: [_request(k, temperature=0.8, system=True)  # noqa: E731
                    for k in range(3)]
    want = _streams(_serve(reqs(), **CONFIGS["paged-int8"]))
    eng = _engine("paged-int8")
    eng._degraded = True
    eng.degrade_low = -1.0          # unreachable: stays degraded throughout
    for r in reqs():
        eng.submit(r)
    eng.run(300)
    assert _streams(eng) == want
    assert eng.stats["decode_calls"] * 1 == eng.tick    # one-tick windows
    assert eng.pool_stats()["cached"] == 0              # insertion paused
    _assert_no_leaks(eng)


def test_pool_pressure_degrades_and_recovers_in_a_run():
    """Under a pool tight enough to cross the high watermark the windows
    step down to one tick and back, and the streams equal an undegraded
    engine's (the same traffic on a pool too large to cross it)."""
    reqs = lambda: [_request(k, temperature=0.8, max_new=10,  # noqa: E731
                             prompt_len=6) for k in range(4)]
    want = _streams(_serve(reqs(), kv_layout="paged", block_size=4,
                           decode_ticks=4, num_blocks=64))
    eng = _serve(reqs(), kv_layout="paged", block_size=4, decode_ticks=4,
                 num_blocks=8, degrade_high=0.75, degrade_low=0.5,
                 trace="mem")
    assert _streams(eng) == want
    assert eng.metrics.counters["degrade_events"] >= 1
    events = [r["name"] for r in eng.trace.records()
              if r.get("kind") == "event"]
    assert "degraded" in events and "restored" in events
    ticks = [r["n_ticks"] for r in eng.trace.records()
             if r.get("name") == "decode_window" and r["rid"] is None]
    first_one = ticks.index(1)                  # stepped down ...
    assert 4 in ticks[:first_one] and 4 in ticks[first_one:]   # ... and back
    _assert_no_leaks(eng)


# --------------------------------------------------- snapshot/restore pins


def _workload(temperature, n=4, **kw):
    return [_request(k, temperature=temperature, max_new=5 + k % 2, **kw)
            for k in range(n)]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_snapshot_restore_is_bitwise(name, temperature):
    """Stop an engine mid-flight, serialize it through real JSON, restore
    it in place, continue: streams, finish reasons, FCFS order and pool
    accounting equal the uninterrupted run's, and the rebuilt cache equals
    the uninterrupted cache byte for byte."""
    ref_reqs = _workload(temperature)
    ref = _serve(ref_reqs, name=name, scheduler="priority")
    _assert_fcfs_within_priority(ref_reqs)

    eng = _engine(name, scheduler="priority")
    for r in _workload(temperature):
        eng.submit(r)
    # mid-flight: the first wave decoding, the second one queued (greedy)
    # or decoding after a finish (sampled)
    for _ in range(2 if temperature == 0 else 4):
        eng.step()
    before = eng.written_kv()
    assert before
    snap = json.loads(json.dumps(eng.snapshot()))
    eng.restore(snap)
    Engine.compare_written_kv(before, eng.written_kv())
    eng.run(300)
    assert _streams(eng) == _streams(ref)
    by_rid = {r.rid: r for r in eng.finished}
    _assert_fcfs_within_priority([by_rid[rid] for rid in sorted(by_rid)])
    assert eng.metrics.counters["recoveries"] == 1
    _assert_no_leaks(eng)


def test_snapshot_restores_into_fresh_engine_from_file(tmp_path):
    """Cold-process shape: snapshot to disk, build a new Engine, restore,
    re-attach streaming callbacks by rid."""
    kw = dict(kv_layout="paged", block_size=8, decode_ticks=2)
    expected = _streams(_serve([_request(r) for r in range(4)], **kw))
    eng = _engine(snapshot_path=str(tmp_path / "snap.json"), **kw)
    for r in range(4):
        eng.submit(_request(r))
    for _ in range(2):
        eng.step()
    del eng                                     # "crash": engine object gone
    tokens = {r: [] for r in range(4)}
    streams = {r: (lambda req, tok, _r=r: tokens[_r].append(tok))
               for r in range(4)}
    fresh = _engine(**kw)
    with open(tmp_path / "snap.json") as fh:
        fresh.restore(json.load(fh), streams=streams)
    fresh.run(300)
    assert _streams(fresh) == expected
    assert any(tokens.values())
    for r in fresh.finished:
        got = tokens[r.rid]
        if got:
            assert r.out[-len(got):] == got
    _assert_no_leaks(fresh)


def test_restore_rejects_layout_mismatch():
    snap = _engine("paged-bf16").snapshot()
    with pytest.raises(ValueError, match="kv_layout"):
        _engine("ring-bf16").restore(snap)


def _restore_at_every_step(reqs_fn, steps, **kw):
    """For each stop in ``steps``: serve to it, check the restored cache
    against the uninterrupted one byte for byte (in place), finish, and
    hold the streams to an uninterrupted run's.  Returns the
    uninterrupted engine."""
    ref = _serve(reqs_fn(), **kw)
    for stop in steps:
        eng = _engine(**kw)
        for r in reqs_fn():
            eng.submit(r)
        for _ in range(stop):
            eng.step()
        before = eng.written_kv()
        eng.restore(json.loads(json.dumps(eng.snapshot())))
        Engine.compare_written_kv(before, eng.written_kv())
        eng.run(300)
        assert _streams(eng) == _streams(ref), stop
        _assert_no_leaks(eng)
    return ref


@pytest.mark.parametrize("kw", [
    dict(prefill_chunk=3, kv_quant=True),
    dict(prefill_chunk=4, decode_ticks=2),
    dict(kv_layout="paged", block_size=4, prefill_chunk=4, kv_quant=True),
], ids=["ring-int8-chunk3", "ring-bf16-chunk4-w2", "paged-int8-chunk4"])
def test_restore_with_chunks_in_flight(kw):
    """The reference re-prefills a chunked prompt whole, which is not the
    chunks' bits; the port replays admission's chunks.  Long prompts keep
    chunks in flight across several stops."""
    reqs = lambda: [_request(k, temperature=0.8, prompt_len=9 + 3 * k,  # noqa: E731
                             max_new=4) for k in range(3)]
    ref = _restore_at_every_step(reqs, range(1, 7), **kw)
    assert ref.stats["prefill_calls"] > 3


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_restore_with_prefix_hits(kv_quant):
    """Requests sharing a 2-block system prompt hit the prefix cache; a
    restore rebuilds the shared blocks (by their writer's unit, or by a
    ghost of its admission when the writer finished) and re-runs each
    hit's suffix prefill."""
    reqs = lambda: [_request(k, temperature=0.8, system=True,  # noqa: E731
                             max_new=4 + k) for k in range(5)]
    ref = _restore_at_every_step(reqs, range(1, 9), kv_layout="paged",
                                 block_size=4, kv_quant=kv_quant)
    assert ref.stats["prefix_hit_tokens"] > 0


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_restore_rebuilds_a_shared_prefix_from_its_finished_writer(kv_quant):
    """The writer of a shared prefix finished before the snapshot, and its
    prompt (10 tokens) and the holder's (20) fall in different length
    buckets: the restore rebuilds the prefix by a ghost of the writer's
    own admission (its bucket, so on the card its bits), one level before
    the holder, and the holder's prefill starts at its prefix hit."""
    writer = lambda: _request(0, temperature=0.8, system=True,  # noqa: E731
                              prompt_len=2, max_new=2)
    holder = lambda: _request(1, temperature=0.8, system=True,  # noqa: E731
                              prompt_len=12, max_new=8)
    kw = dict(kv_layout="paged", block_size=4, kv_quant=kv_quant)

    def run():
        eng = _engine(**kw)
        eng.submit(writer())
        eng.run(50)
        eng.submit(holder())
        return eng

    ref = run()
    ref.run(50)
    eng = run()
    for _ in range(3):
        eng.step()
    assert eng.stats["prefix_hit_tokens"] == len(SYSTEM)
    assert [r.rid for r in eng.finished] == [0] and eng.slots[0] is not None
    before = eng.written_kv()
    eng.restore(json.loads(json.dumps(eng.snapshot())))
    assert eng.last_restore["ghosts"] == 1
    assert eng.last_restore["levels"] == 2
    # the holder's suffix call and the ghost's whole-prompt call, no more
    assert eng.last_restore["prefill_calls"] == 2
    Engine.compare_written_kv(before, eng.written_kv())
    eng.run(50)
    assert _streams(eng) == _streams(ref)
    _assert_no_leaks(eng)


def test_restore_with_preempted_block_holders():
    """A queued request preempted with its blocks holds KV the reference's
    restore does not rebuild; the port's does."""
    reqs = lambda: [_request(k, temperature=0.8, max_new=9,  # noqa: E731
                             prompt_len=5) for k in range(3)]
    kw = dict(kv_layout="paged", block_size=4, num_blocks=6,
              prefix_cache=False, kv_quant=True)
    ref = _restore_at_every_step(reqs, range(2, 12), **kw)
    assert ref.stats["preemptions"] >= 1


def test_restore_rebuilds_prefix_cached_blocks_nobody_holds():
    """A finished request's sealed blocks linger in the prefix cache; the
    reference drops them at a restore, so a later request would prefill
    cold instead of hitting.  The port rebuilds them from their writer
    (``block_src``) and the later request hits as it would have."""
    first = lambda: _request(0, temperature=0.8, system=True,  # noqa: E731
                             max_new=3)
    later = lambda: _request(1, temperature=0.8, system=True,  # noqa: E731
                             max_new=4)
    kw = dict(kv_layout="paged", block_size=4, kv_quant=True)
    ref = _engine(**kw)
    ref.submit(first())
    ref.run(50)
    ref.submit(later())
    ref.run(50)
    assert ref.stats["prefix_hit_tokens"] == len(SYSTEM)

    eng = _engine(**kw)
    eng.submit(first())
    eng.run(50)
    assert eng.pool_stats()["cached"] >= 2 and eng.pool.live_blocks == 0
    snap = json.loads(json.dumps(eng.snapshot()))
    fresh = _engine(**kw)
    fresh.restore(snap)
    assert fresh.last_restore["ghosts"] == 1
    assert fresh.pool_stats()["cached"] == eng.pool_stats()["cached"]
    fresh.submit(later())
    fresh.run(50)
    assert _streams(fresh) == _streams(ref)
    assert fresh.stats["prefix_hit_tokens"] == len(SYSTEM)
    # without the writer record the cached blocks are dropped (the
    # reference's behaviour) and the later request prefills cold
    del snap["block_src"]
    cold = _engine(**kw)
    cold.restore(snap)
    assert cold.pool_stats()["cached"] == 0
    cold.submit(later())
    cold.run(50)
    assert cold.stats["prefix_hit_tokens"] == 0


# ------------------------------------------------- injector + restart loop


def _crash_kw():
    return dict(kv_layout="paged", block_size=8, decode_ticks=2)


def test_injector_crash_points_recover_bitwise(tmp_path):
    """Every serve crash phase, through ``run_serve_with_restarts`` with a
    fresh engine per restart: recovery is bitwise, the injector fires
    once, nothing leaks."""
    reqs = lambda: [_request(r, temperature=0.8) for r in range(4)]  # noqa: E731
    expected = _streams(_serve(reqs(), **_crash_kw()))
    for phase in SERVE_PHASES:
        snap_path = str(tmp_path / f"snap_{phase}.json")
        injector = FailureInjector(crash_at={2: phase})

        def make_engine():
            return _engine(injector=injector, snapshot_path=snap_path,
                           **_crash_kw())

        def submit(engine):
            for r in reqs():
                engine.submit(r)

        eng = run_serve_with_restarts(make_engine, submit,
                                      snapshot_path=snap_path, ticks=300)
        assert _streams(eng) == expected, phase
        assert injector.fired == {(2, phase)}
        assert eng.metrics.counters["recoveries"] == 1
        _assert_no_leaks(eng)


@pytest.mark.parametrize("kw", [
    dict(kv_quant=True),
    dict(kv_quant=True, decode_ticks=2, prefill_chunk=4),
    dict(kv_layout="paged", block_size=4, num_blocks=7, kv_quant=True),
], ids=["ring-int8", "ring-int8-w2-chunk4", "paged-int8-pressure"])
def test_all_five_crash_points_in_one_run(tmp_path, kw):
    """One schedule firing all five phases at distinct ticks (the ring's
    ``pool_alloc`` point sits where the paged engine allocates): five
    recoveries, the uninterrupted streams, no leaks."""
    reqs = lambda: [_request(k, temperature=0.8, prompt_len=6 + 2 * k,  # noqa: E731
                             max_new=6, system=k % 2 == 1) for k in range(5)]
    expected = _streams(_serve(reqs(), **kw))
    w = kw.get("decode_ticks", 1)
    crash = {w * (2 + 2 * i): phase for i, phase in enumerate(SERVE_PHASES)}
    snap_path = str(tmp_path / "snap.json")
    injector = FailureInjector(crash_at=crash)

    def make_engine():
        return _engine(injector=injector, snapshot_path=snap_path, **kw)

    def submit(engine):
        for r in reqs():
            engine.submit(r)

    eng = run_serve_with_restarts(make_engine, submit, max_restarts=5,
                                  snapshot_path=snap_path, ticks=300)
    assert injector.fired == set(crash.items())
    assert eng.metrics.counters["recoveries"] == 5
    assert _streams(eng) == expected
    _assert_no_leaks(eng)


def test_injector_unrecoverable_after_max_restarts(tmp_path):
    snap_path = str(tmp_path / "snap.json")

    def make_engine():
        return Engine(PARAMS, CFG, 1, MAX_LEN, device="cpu",
                      injector=FailureInjector(crash_at={0: "pre_admit"}),
                      snapshot_path=snap_path)

    def submit(engine):
        engine.submit(_request(0))

    with pytest.raises(RuntimeError, match="after 1 restarts"):
        run_serve_with_restarts(make_engine, submit,
                                snapshot_path=snap_path, ticks=50,
                                max_restarts=1)


def test_restart_loop_catches_injected_crashes_only():
    """Any other error is a fault of the program and is not retried."""
    calls = []

    def loop(i):
        calls.append(i)
        if i == 0:
            FailureInjector({0: "x"}).maybe_fail(0, "x")
        raise KeyError("a bug")

    with pytest.raises(KeyError):
        run_with_restarts(loop, max_restarts=3)
    assert calls == [0, 1]


def test_restart_loop_frees_the_crashed_attempt_first():
    """The crashed attempt's engine (its cache; on the card its graphs) is
    gone before the next attempt builds its own."""
    seen = []

    def loop(i):
        if seen:
            gc.disable()                 # only the loop may have collected
            try:
                assert seen[-1]() is None, "crashed engine still alive"
            finally:
                gc.enable()
            return i
        eng = _engine()
        eng.self_ref = eng               # a reference cycle, as in a crash
        seen.append(weakref.ref(eng))
        raise InjectedFailure("boom")

    assert run_with_restarts(loop, max_restarts=1) == 1


def test_training_restart_loop_converges():
    injector = FailureInjector(crash_at={3: "before_save", 5: "after_save"})
    calls = []

    def loop(restart_idx):
        calls.append(restart_idx)
        for step in range(8):
            injector.maybe_fail(step, "before_save")
            injector.maybe_fail(step, "after_save")
        return 8

    assert run_with_restarts(loop) == 8 and calls == [0, 1, 2]
    w = StragglerWatchdog(threshold=3.0)
    for i in range(10):
        w.observe(i, 0.1)
    assert w.observe(10, 1.0) is True and 10 in w.flagged
    assert w.observe(11, 0.11) is False


# ---------------------------------------------------------------- watchdog


class _ListSink:
    def __init__(self):
        self.records = []

    def write(self, records):
        self.records.extend(records)

    def close(self):
        pass


def test_watchdog_flags_slow_windows_through_the_sink():
    msink, tsink = _ListSink(), _ListSink()
    eng = Engine(PARAMS, CFG, 1, MAX_LEN, metrics=msink, trace=tsink,
                 watchdog=StragglerWatchdog(threshold=0.0, warmup=1),
                 device="cpu")
    eng.submit(_request(0, max_new=6))
    eng.run(100)
    eng.metrics.flush()
    eng.trace.flush()
    slow = eng.metrics.counters["slow_windows"]
    assert slow > 0
    events = [r for r in tsink.records
              if r.get("kind") == "event" and r.get("name") == "slow_window"]
    assert len(events) == slow
    assert all("window_s" in e and "tick" in e for e in events)
    assert not any(r.get("event") == "slow_window" for r in msink.records)
    ticks = [r for r in msink.records if "queue_depth" in r]
    assert ticks and all("window_s" in r for r in ticks)


def test_watchdog_defaults_on_and_quiet():
    assert isinstance(_engine().watchdog, StragglerWatchdog)
    assert _engine(watchdog=False).watchdog is None


# ----------------------------------------------------- across the packages


RCFG = ref_get_config("smollm_135m").reduced()
RPARAMS = ref_registry.init_model(jax.random.PRNGKey(0), RCFG)
RTORCH = params_from_numpy(jax.tree.map(np.asarray, RPARAMS), "cpu")


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_reference_snapshot_restores_into_the_port(layout, kv_quant,
                                                   monkeypatch):
    """The reference's engine runs two windows and writes a snapshot; the
    port's engine restores it on the same weights and finishes with the
    reference's uninterrupted streams (every decision of which clears
    twice the logit tolerance)."""
    if layout == "ring":
        want = _reference(23, "fcfs", kv_quant, monkeypatch)
        reqs = _requests(23, ref_engine)
        kw = {}
    else:
        want = _reference_paged(9, kv_quant, monkeypatch)[0]
        reqs = _stream_requests(9, ref_engine)
        kw = dict(kv_layout="paged", block_size=8)
    ref = ref_engine.Engine(RPARAMS, RCFG, batch=2, max_len=64,
                            kv_quant=kv_quant, **kw)
    for r in reqs:
        ref.submit(r)
    for _ in range(2):
        ref.step()
    assert any(s is not None and s.out for s in ref.slots)
    snap = json.loads(json.dumps(ref.snapshot()))
    port = Engine(RTORCH, CFG, 2, 64, kv_quant=kv_quant, device="cpu", **kw)
    port.restore(snap)
    done = sorted(port.run(100), key=lambda r: r.rid)
    assert [(r.rid, r.finish_reason, r.out) for r in done] == want
    # and the port's snapshot is one the reference restores
    back = ref_engine.Engine(RPARAMS, RCFG, batch=2, max_len=64,
                             kv_quant=kv_quant, **kw)
    back.restore(json.loads(json.dumps(port.snapshot())))
    assert [r.out for r in sorted(back.finished, key=lambda r: r.rid)] == [
        r.out for r in done]


def test_reference_replay_runs_a_short_recurrent_row_past_its_tokens():
    """A fault in the reference's restore that the port does not share:
    its teacher-forced replay (``_replay_fn_for``) freezes only the
    position of a row out of tokens, so in a model with recurrent state a
    slot that generated fewer tokens than the deepest one is stepped on
    token 0 until the replay ends, and its state is no longer the one it
    served with.  mamba2-370m at ``.reduced()``, two slots at 3 and 5
    generated tokens at the snapshot: the reference's restored state of
    the shorter row differs from its own uninterrupted state by far more
    than rounding, and its streams after the restore differ from its
    uninterrupted streams; the port's restore of its own snapshot at the
    same point equals its uninterrupted cache byte for byte and finishes
    with its uninterrupted streams."""
    from _torch_zoo import exact_reference_jit, model

    rcfg, pcfg, rparams, tparams = model("mamba2_370m")

    def reqs(mod):
        rng = np.random.default_rng(0)
        return [mod.Request(rid=r, prompt=rng.integers(
            1, pcfg.vocab_size, size=int(rng.integers(3, 14))).tolist(),
            sampling=mod.SamplingParams(seed=r, max_new=3 + 3 * r))
            for r in range(4)]

    def serve(make, mod, stop=None):
        eng = make()
        for r in reqs(mod):
            eng.submit(r)
        for _ in range(stop or 0):
            eng.step()
        if stop is None:
            eng.run(200)
        return eng

    with exact_reference_jit():
        make = lambda: ref_engine.Engine(rparams, rcfg, batch=2,  # noqa: E731
                                         max_len=32, decode_ticks=2)
        want = {r.rid: r.out for r in serve(make, ref_engine).finished}
        ref = serve(make, ref_engine, stop=2)
        lens = [len(s.out) for s in ref.slots]
        assert sorted(lens) == [3, 5]
        short = lens.index(3)
        h_before = np.asarray(ref.cache["layers"][0]["h"][:, short])
        ref.restore(json.loads(json.dumps(ref.snapshot())))
        h_after = np.asarray(ref.cache["layers"][0]["h"][:, short])
        assert np.abs(h_after - h_before).max() > 1.0
        ref.run(200)
        assert {r.rid: r.out for r in ref.finished} != want

    make = lambda: Engine(tparams, pcfg, 2, 32, device="cpu",  # noqa: E731
                          decode_ticks=2)
    want = _streams(serve(make, port_engine))
    port = serve(make, port_engine, stop=2)
    assert sorted(len(s.out) for s in port.slots) == [3, 5]
    before = port.written_kv()
    port.restore(json.loads(json.dumps(port.snapshot())))
    Engine.compare_written_kv(before, port.written_kv())
    port.run(200)
    assert _streams(port) == want
