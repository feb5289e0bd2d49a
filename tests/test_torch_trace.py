"""The port's tracer (``repro_torch.serve.trace``, DESIGN.md §13) against the
reference's ``repro.serve.trace``, and the reference's engine pins of
``tests/test_trace.py`` re-pinned on the port's engine at
``smollm_135m.reduced()`` on the CPU.

Parity class: exact.  The tracer is host bookkeeping on the timestamps it
is given, so both packages, fed the same lifecycle calls with the same
stamps, give equal explain reports, records and Perfetto JSON.  Engine
pins: tracing changes no stream (ring/paged × bf16/int8 with windows and
chunked prefill), every finished request's shares sum to 100%, the feed
carries the queue and pool provenance, the Perfetto export matches the
jsonl feed, a failing sink is isolated, and timelines stay continuous
across a crash and restore.  The reference's autotune-observer pins become
the port's cold-start observer (kernel builds, graph captures)."""

import json
import weakref

import pytest

import repro.serve.trace as ref_trace
from repro_torch import coldstart
from repro_torch.configs import get_config
from repro_torch.dist.fault_tolerance import (FailureInjector,
                                              run_serve_with_restarts)
from repro_torch.models import registry
from repro_torch.serve import (Engine, JsonlSink, NullSink, Request,
                               SamplingParams, Tracer, format_explain)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = get_config("smollm_135m").reduced()
PARAMS = registry.init_model(CFG, seed=0, device="cpu")
MAX_LEN = 32
EOS = 11

# ring/paged × bf16/int8, windows + chunked piggyback prefill on — the
# paths where the tracer hooks are densest
CONFIGS = {
    "ring-bf16": dict(decode_ticks=4, prefill_chunk=2),
    "ring-int8": dict(decode_ticks=4, prefill_chunk=2, kv_quant=True),
    "paged-bf16": dict(kv_layout="paged", block_size=8, decode_ticks=4,
                       prefill_chunk=8),
    "paged-int8": dict(kv_layout="paged", block_size=8, decode_ticks=4,
                       prefill_chunk=8, kv_quant=True),
}


def _request(rid, key=None, temperature=0.0, max_new=5, **kw):
    key = rid if key is None else key
    prompt = [(7 * key + i) % (CFG.vocab_size - 1) + 1
              for i in range(4 + key % 3)]
    return Request(rid=rid, prompt=prompt, priority=key % 2,
                   sampling=SamplingParams(temperature=temperature, seed=key,
                                           max_new=max_new, eos_id=EOS,
                                           counter_offset=100 * key), **kw)


def _assert_contiguous(report):
    segs = report["segments"]
    assert segs, "finished request with no segments"
    for a, b in zip(segs, segs[1:]):
        assert b["t0"] == pytest.approx(a["t1"]), "timeline gap"
    assert sum(report["shares"].values()) == pytest.approx(1.0, abs=0.01)


# ---------------------------------------------------------- against the
# reference's tracer (exact)


def _drive(tr):
    """One fixed lifecycle script with explicit stamps: a queued wait, a
    chunked prefill, decode waves, a preempt stall, degradation, a shed
    request, counters, a snapshot, and a restore into a second tracer."""
    tr.begin(0, 10.0, priority=1)
    tr.begin(1, 10.1, priority=0)
    tr.begin(2, 10.2)
    tr.finish(2, 10.2, "shed")
    tr.phase(0, "prefill", 10.5, slot=0, blocks=2, prefix_tokens=0)
    tr.wave("prefill_wave", 10.5, 10.7,
            [(0, "prefill[0]", {"slot": 0, "tokens": 8})], tick=0)
    tr.phase(0, "decode", 10.7, slot=0)
    tr.phase(1, "prefill", 10.8, slot=1)
    tr.counters(t=10.8, queue_depth=1, live_blocks=3, degraded=0)
    tr.set_degraded(True, 11.0)
    tr.event("degraded", t=11.0, tick=4, live_share=0.9)
    tr.phase(1, "decode", 11.1, slot=1)
    tr.wave("decode_window", 11.1, 11.4,
            [(0, "decode[w4]", {"slot": 0, "tokens": 4}),
             (1, "decode[w4]", {"slot": 1, "tokens": 3})],
            tick=4, n_ticks=4)
    tr.phase(1, "preempt_stall", 11.5, slot=1, blocks=3)
    tr.event("queue_requeue", t=11.5, rid=1, arrival=1, depth=1)
    tr.set_degraded(False, 11.75)
    tr.event("restored", t=11.75, tick=8, live_share=0.5)
    tr.finish(0, 12.0, "length", slot=0)
    snap = json.loads(json.dumps(tr.snapshot(12.1)))
    return snap


def test_tracer_equals_reference():
    ours, ref = Tracer(), ref_trace.Tracer()
    snap_o, snap_r = _drive(ours), _drive(ref)
    assert snap_o == snap_r
    assert ours.records() == ref.records()
    for rid in (0, 1, 2):
        rep = ours.explain(rid, now=12.5)
        assert rep == ref.explain(rid, now=12.5)
        assert format_explain(rep) == ref_trace.format_explain(rep)
    assert ours.perfetto() == ref.perfetto()
    # each restores the other's snapshot into the same timelines
    a, b = Tracer(), ref_trace.Tracer()
    a.restore(snap_r, t=13.0)
    b.restore(snap_o, t=13.0)
    a.finish(1, 14.0, "length")
    b.finish(1, 14.0, "length")
    assert a.explain(1) == b.explain(1)
    assert a.records() == b.records()
    assert a.perfetto() == b.perfetto()
    _assert_contiguous(a.explain(1))


def test_from_spec_parsing(tmp_path):
    assert Tracer.from_spec(None).enabled is False
    t = Tracer.from_spec("mem")
    assert t.enabled and isinstance(t.sink, NullSink) and t._retain
    assert Tracer.from_spec(t) is t
    combo = Tracer.from_spec(f"perfetto:{tmp_path}/t.json,"
                             f"jsonl:{tmp_path}/t.jsonl")
    assert combo.perfetto_path == f"{tmp_path}/t.json"
    assert isinstance(combo.sink, JsonlSink) and combo._retain
    feed_only = Tracer.from_spec(str(tmp_path / "feed.jsonl"))
    assert isinstance(feed_only.sink, JsonlSink)
    assert not feed_only._retain

    class Sink:
        def write(self, records):
            pass

    sink = Sink()
    assert Tracer.from_spec(sink).sink is sink
    with pytest.raises(ValueError):
        Tracer.from_spec("csv:/tmp/x")
    with pytest.raises(TypeError):
        Tracer.from_spec(42)


def test_phase_segments_partition_wall_exactly():
    tr = Tracer()
    tr.begin(0, 10.0, priority=1)
    tr.phase(0, "prefill", 10.5, slot=0)
    tr.phase(0, "decode", 11.0, slot=0)
    tr.set_degraded(True, 11.25)
    tr.set_degraded(False, 11.75)
    tr.finish(0, 12.0, "length")
    rep = tr.explain(0)
    assert rep["wall_s"] == pytest.approx(2.0)
    for cat in ("queue", "prefill", "decode", "degraded"):
        assert rep["seconds"][cat] == pytest.approx(0.5), cat
    _assert_contiguous(rep)
    line = format_explain(rep)
    assert line.startswith("req 0:") and "[length]" in line
    assert "degraded=25.0%" in line


def test_tracer_snapshot_restore_bridges_open_spans():
    tr = Tracer()
    tr.begin(7, 1.0)
    tr.phase(7, "decode", 1.2, slot=0)
    snap = json.loads(json.dumps(tr.snapshot(1.4)))
    tr2 = Tracer()
    tr2.restore(snap, t=1.9)
    tr2.finish(7, 2.0, "length")
    rep = tr2.explain(7)
    phases = [(s["phase"], round(s["t1"] - s["t0"], 6))
              for s in rep["segments"]]
    assert phases == [("queued", 0.2), ("decode", 0.2),
                      ("recovery", 0.5), ("decode", 0.1)]
    _assert_contiguous(rep)
    marked = [r for r in tr2.records()
              if r.get("kind") == "span" and r.get("recovery") == 1]
    assert len(marked) == 1 and marked[0]["name"] == "decode"


def test_explain_live_request_attributes_up_to_now():
    tr = Tracer()
    tr.begin(3, 5.0)
    rep = tr.explain(3, now=7.0)
    assert not rep["done"] and rep["wall_s"] == pytest.approx(2.0)
    assert rep["shares"]["queue"] == pytest.approx(1.0)
    assert "live" in format_explain(rep)


# ------------------------------------------------------- engine integration


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tracing_is_bitwise_invisible(name):
    def serve(traced):
        eng = Engine(PARAMS, CFG, 2, MAX_LEN, trace="mem" if traced else None,
                     device="cpu", **CONFIGS[name])
        for k in range(4):
            eng.submit(_request(k, temperature=0.8))
        eng.run(300)
        return eng, {r.rid: (list(r.out), r.finish_reason)
                     for r in eng.finished}

    _, want = serve(False)
    eng, got = serve(True)
    assert got == want
    for r in eng.finished:
        rep = eng.explain(r.rid)
        assert rep["done"] and rep["finish_reason"] == r.finish_reason
        assert rep["seconds"]["decode"] > 0.0 or r.out == []
        _assert_contiguous(rep)


def test_explain_requires_an_enabled_tracer():
    eng = Engine(PARAMS, CFG, 2, MAX_LEN, device="cpu")
    with pytest.raises(RuntimeError, match="trace"):
        eng.explain(0)


def test_explain_shares_sum_on_mixed_workload():
    """Chunked prefill, pool pressure (preemptions) and a deadline expiry
    on one traced engine: every finished request's shares sum to 100%.
    The deadline is 0 s, so it has passed at the first window whatever
    the clock reads."""
    eng = Engine(PARAMS, CFG, 2, MAX_LEN, kv_layout="paged", block_size=4,
                 num_blocks=5, prefix_cache=False, decode_ticks=2,
                 prefill_chunk=4, scheduler="priority", trace="mem",
                 device="cpu")
    reqs = [_request(r, key=r, max_new=8) for r in range(3)]
    reqs.append(_request(3, key=3, deadline_s=0.0))
    for r in reqs:
        eng.submit(r)
    done = eng.run(400)
    assert len(done) == 4
    assert eng.stats["preemptions"] >= 1
    reasons = {r.rid: r.finish_reason for r in done}
    assert reasons[3] == "deadline"
    saw_stall = False
    for r in done:
        rep = eng.explain(r.rid)
        assert rep["done"] and rep["finish_reason"] == reasons[r.rid]
        _assert_contiguous(rep)
        saw_stall = saw_stall or rep["seconds"]["preempt_stall"] > 0.0
    assert saw_stall
    rep = eng.explain(3)
    assert rep["dominant"] == "queue"
    assert rep["shares"]["queue"] == pytest.approx(1.0, abs=0.01)


def test_queue_and_pool_provenance_events_reach_the_feed():
    eng = Engine(PARAMS, CFG, 2, MAX_LEN, kv_layout="paged", block_size=4,
                 num_blocks=5, prefix_cache=False, trace="mem", device="cpu")
    for r in range(3):
        eng.submit(_request(r, key=r, max_new=8))
    eng.run(300)
    events = {r["name"] for r in eng.trace.records()
              if r.get("kind") == "event"}
    assert {"submit", "finish", "queue_enter", "queue_requeue"} <= events
    waves = [r for r in eng.trace.records()
             if r.get("kind") == "span" and r.get("cat") == "wave"]
    assert any(r["name"] == "prefill_wave" and r["rid"] is None
               for r in waves)
    assert any(r["name"] == "decode_window" and r["rid"] is None
               for r in waves)
    assert any(r["rid"] is not None and r["name"].startswith("decode[")
               for r in waves)


def test_deadlock_breaker_emits_reprefill_event():
    eng = Engine(PARAMS, CFG, 2, 16, kv_layout="paged", block_size=4,
                 num_blocks=3, prefix_cache=False, trace="mem", device="cpu")
    for r in range(2):
        eng.submit(Request(rid=r, prompt=[1 + r, 2, 3], max_new=10))
    done = eng.run(300)
    assert len(done) == 2
    reprefills = [r for r in eng.trace.records()
                  if r.get("kind") == "event" and r["name"] == "reprefill"]
    assert reprefills and all("pos" in e and "rid" in e for e in reprefills)
    for r in done:
        _assert_contiguous(eng.explain(r.rid))


def test_spec_windows_put_their_three_waves_on_the_trace():
    eng = Engine(PARAMS, CFG, 2, MAX_LEN, spec_decode=True, draft_k=3,
                 trace="mem", device="cpu")
    for r in range(2):
        eng.submit(Request(rid=r, prompt=[1, 2, 1, 2, 5 + r], max_new=4))
    eng.run(50)
    names = {r["name"] for r in eng.trace.records()
             if r.get("cat") == "wave" and r["rid"] is None}
    assert {"spec_draft", "spec_verify", "spec_commit",
            "prefill_wave"} <= names


def test_perfetto_export_matches_jsonl_feed(tmp_path):
    pf_path = tmp_path / "trace.json"
    feed_path = tmp_path / "trace.jsonl"
    eng = Engine(PARAMS, CFG, 2, MAX_LEN, decode_ticks=2, device="cpu",
                 trace=f"perfetto:{pf_path},jsonl:{feed_path}")
    for r in range(3):
        eng.submit(_request(r, key=r))
    eng.run(300)
    eng.trace.close()
    feed = [json.loads(ln) for ln in feed_path.read_text().splitlines()]
    feed_spans = sorted(
        (r["rid"], r["name"], round(1e6 * (r["t1"] - r["t0"])))
        for r in feed if r.get("kind") == "span" and r.get("rid") is not None)
    pf = json.loads(pf_path.read_text())
    pf_spans = sorted(
        (e["tid"], e["name"], round(e["dur"]))
        for e in pf["traceEvents"] if e["ph"] == "X" and e["pid"] == 1)
    assert pf_spans == feed_spans and feed_spans
    names = [e for e in pf["traceEvents"] if e["ph"] == "M"]
    assert any(e["args"].get("name") == "engine" for e in names)
    assert any(e["args"].get("name") == "req 0" for e in names)
    assert any(e["ph"] == "X" and e["pid"] == 0 for e in pf["traceEvents"])
    assert any(e["ph"] == "C" for e in pf["traceEvents"])


def test_trace_sink_crash_is_isolated():
    class BoomSink:
        def write(self, records):
            raise IOError("disk full")

        def close(self):
            pass

    eng = Engine(PARAMS, CFG, 2, MAX_LEN, device="cpu",
                 trace=Tracer(sink=BoomSink(), flush_every=1))
    for r in range(2):
        eng.submit(_request(r, key=r))
    done = eng.run(200)
    assert len(done) == 2
    assert all(r.finish_reason in ("length", "eos") for r in done)
    assert eng.trace.sink_errors == 1
    assert isinstance(eng.trace.sink, NullSink)


def test_trace_continuity_across_injected_crash(tmp_path):
    """A mid-window crash and restart keeps every timeline contiguous, with
    a recovery bridge, and the streams of an uninterrupted untraced run."""
    kw = dict(kv_layout="paged", block_size=8, decode_ticks=2, device="cpu")
    ref = Engine(PARAMS, CFG, 2, MAX_LEN, **kw)
    for r in range(4):
        ref.submit(_request(r, key=r, temperature=0.8))
    ref.run(300)
    want = {r.rid: (list(r.out), r.finish_reason) for r in ref.finished}

    snap_path = str(tmp_path / "snap.json")
    injector = FailureInjector(crash_at={2: "mid_window"})

    def make_engine():
        return Engine(PARAMS, CFG, 2, MAX_LEN, injector=injector,
                      snapshot_path=snap_path, trace="mem", **kw)

    def submit(engine):
        for r in range(4):
            engine.submit(_request(r, key=r, temperature=0.8))

    eng = run_serve_with_restarts(make_engine, submit,
                                  snapshot_path=snap_path, ticks=300)
    assert injector.fired == {(2, "mid_window")}
    assert {r.rid: (list(r.out), r.finish_reason)
            for r in eng.finished} == want
    bridged = 0
    for r in eng.finished:
        rep = eng.explain(r.rid)
        assert rep["done"]
        _assert_contiguous(rep)
        bridged += any(s["phase"] == "recovery" for s in rep["segments"])
    assert bridged > 0
    recs = eng.trace.records()
    assert any(r.get("kind") == "event" and r.get("name") == "recovery"
               for r in recs)
    assert any(r.get("carried") == 1 for r in recs)


# --------------------------------------------------- cold-start observer


def test_coldstart_observer_feeds_build_and_capture_events():
    """Kernel builds and graph captures, the port's cold-start stalls,
    reach every enabled tracer's feed; a disabled one registers not."""
    tr, off = Tracer(), Tracer(enabled=False)
    coldstart.notify("kernel_build", kernel="decode_attention", seconds=12.5)
    coldstart.notify("graph_capture", ticks=8, stop_width=1, seconds=1.25)
    events = [r for r in tr.records() if r.get("kind") == "event"]
    assert [(e["name"], e["seconds"]) for e in events] == [
        ("kernel_build", 12.5), ("graph_capture", 1.25)]
    assert events[0]["kernel"] == "decode_attention"
    assert events[1]["ticks"] == 8
    assert off not in coldstart._OBSERVERS and not off.records()


def test_dropped_tracer_unregisters_from_the_observer_set():
    tr = Tracer()
    ref = weakref.ref(tr)
    assert tr in coldstart._OBSERVERS
    del tr
    assert ref() is None
    assert all(o is not None for o in coldstart._OBSERVERS)
    coldstart.notify("kernel_build", kernel="quantize", seconds=1.0)
