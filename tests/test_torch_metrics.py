"""The port's metrics surface (``repro_torch.serve.metrics``, DESIGN.md §10)
against the reference's ``repro.serve.metrics``, and the reference's engine
pins of ``tests/test_metrics.py`` re-pinned on the port's engine at
``smollm_135m.reduced()`` on the CPU.

Parity class: exact.  ``Histogram``, the sinks and ``Metrics`` are host
arithmetic on Python floats, so fed the same values in the same order both
packages give equal states, summaries and snapshots, bit for bit (the
records' wall stamps ``t`` aside).  The engine pins hold the counters,
gauges and histograms to the engine's own ``stats`` and pool counts."""

import json
import math

import numpy as np
import pytest

import repro.serve.metrics as ref_metrics
from repro_torch.configs import get_config
from repro_torch.models import registry
from repro_torch.serve import (Engine, Histogram, JsonlSink, Metrics,
                               NullSink, Request, SamplingParams, StdoutSink,
                               make_sink)
from repro_torch.serve.metrics import SinkBuffer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = get_config("smollm_135m").reduced()
PARAMS = registry.init_model(CFG, seed=0, device="cpu")

# value sets fed to both histograms: ordinary latencies, out-of-range
# values, a single sample, random log-uniform draws
VALUES = {
    "ms": [0.001 * (i + 1) for i in range(100)],
    "clamped": [0.0, 1e-9, 5.0, 2e3, 0.3, 1e-5],
    "single": [0.05],
    "random": list(np.exp(np.random.default_rng(0).uniform(
        math.log(1e-6), math.log(2e3), size=500))),
}


def _run_engine(n_requests=4, max_new=4, metrics=None, **eng_kw):
    eng = Engine(PARAMS, CFG, 2, 32, metrics=metrics, device="cpu", **eng_kw)
    for r in range(n_requests):
        eng.submit(Request(
            rid=r, prompt=[1 + r, 2, 3],
            sampling=SamplingParams(max_new=max_new, seed=r,
                                    counter_offset=100 * r)))
    done = eng.run(ticks=n_requests * (max_new + 4) + 20)
    return eng, done


# ---------------------------------------------------------------------------
# against the reference's classes (exact)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"lo": 1e-3, "hi": 1.0, "n_buckets": 8}],
                         ids=["default", "narrow"])
@pytest.mark.parametrize("name", sorted(VALUES))
def test_histogram_equals_reference(name, kw):
    ours, ref = Histogram(**kw), ref_metrics.Histogram(**kw)
    assert ours.summary() == ref.summary()              # empty
    for v in VALUES[name]:
        ours.record(float(v))
        ref.record(float(v))
    assert ours.state() == ref.state()
    assert ours.summary() == ref.summary()
    for q in (0.0, 1.0, 25.0, 50.0, 95.0, 99.0, 100.0):
        assert ours.percentile(q) == ref.percentile(q)
    back = Histogram.from_state(json.loads(json.dumps(ref.state())))
    assert back.state() == ref.state()


def _feed(m):
    """One fixed sequence of metric calls."""
    for i in range(7):
        m.inc("finished_requests")
        m.inc("spec_draft_tokens", 3 * i)
        m.observe_ttft(0.01 * (i + 1))
        for j in range(i):
            m.observe_itl(0.002 * (j + 1) + 1e-4 * i)
        m.tick(queue_depth=7 - i, batch_occupancy=i / 7, degraded=i % 2,
               window_s=0.003 * i, label="w")


def test_metrics_summary_and_snapshot_equal_reference():
    class Keep:
        def __init__(self):
            self.records = []

        def write(self, records):
            self.records.extend(records)

    ours_sink, ref_sink = Keep(), Keep()
    ours = Metrics(sink=ours_sink, flush_every=3)
    ref = ref_metrics.Metrics(sink=ref_sink, flush_every=3)
    _feed(ours)
    _feed(ref)
    assert ours.summary() == ref.summary()
    assert ours.snapshot() == ref.snapshot()
    assert ours.gauge_mean("window_s") == ref.gauge_mean("window_s")
    ours.flush()
    ref.flush()

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "t"} for r in recs]

    assert strip(ours_sink.records) == strip(ref_sink.records)
    assert len(ours_sink.records) == 7
    # a snapshot either package writes is one the other restores
    a, b = Metrics(), ref_metrics.Metrics()
    a.restore(json.loads(json.dumps(ref.snapshot())))
    b.restore(json.loads(json.dumps(ours.snapshot())))
    assert a.summary() == ref.summary() and b.summary() == ours.summary()
    ours.reset()
    ref.reset()
    assert ours.summary() == ref.summary()


def test_make_sink_specs(tmp_path):
    assert isinstance(make_sink(None), NullSink)
    assert isinstance(make_sink("null"), NullSink)
    assert isinstance(make_sink("stdout"), StdoutSink)
    assert isinstance(make_sink(f"jsonl:{tmp_path}/m.jsonl"), JsonlSink)
    assert isinstance(make_sink(str(tmp_path / "m.jsonl")), JsonlSink)
    sink = NullSink()
    assert make_sink(sink) is sink                      # objects pass through
    with pytest.raises(ValueError):
        make_sink("csv:/tmp/x")
    with pytest.raises(TypeError):
        make_sink(42)


def test_stdout_sink_writes_what_the_reference_writes(capsys):
    recs = [{"a": 1, "b": [1.5, None]}, {"event": "x"}]
    StdoutSink().write(recs)
    ours = capsys.readouterr().out
    ref_metrics.StdoutSink().write(recs)
    assert ours == capsys.readouterr().out and ours.count("\n") == 2


def test_jsonl_sink_close_fsyncs_and_reopen_repairs_torn_tail(tmp_path):
    """close() leaves every record on disk, and a reopening writer
    truncates a torn final line back to the last complete record."""
    path = tmp_path / "m.jsonl"
    sink = JsonlSink(str(path))
    sink.write([{"a": 1}, {"a": 2}])
    sink.close()
    assert sink._fh is None                             # idempotent close
    sink.close()
    with open(path, "a") as fh:
        fh.write('{"a": 3, "torn')                      # no trailing newline
    reopened = JsonlSink(str(path))
    reopened.write([{"a": 4}])
    reopened.close()
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [r["a"] for r in recs] == [1, 2, 4]


def test_jsonl_sink_repairs_file_with_no_complete_line(tmp_path):
    path = tmp_path / "m.jsonl"
    path.write_text('{"partial": ')
    sink = JsonlSink(str(path))
    sink.write([{"a": 1}])
    sink.close()
    assert [json.loads(ln)["a"] for ln in path.read_text().splitlines()] \
        == [1]


def test_sink_buffer_isolates_a_failing_sink(capsys):
    class Boom:
        def write(self, records):
            raise IOError("disk full")

        def close(self):
            raise IOError("still full")

    sb = SinkBuffer(Boom(), flush_every=2)
    for i in range(5):
        sb.add({"i": i})
    assert sb.sink_errors == 1 and isinstance(sb.sink, NullSink)
    assert "disabling sink" in capsys.readouterr().err
    sb.close()
    assert sb.sink_errors == 1          # a NullSink closes cleanly


# ---------------------------------------------------------------------------
# the reference's engine pins, on the port's engine
# ---------------------------------------------------------------------------


def test_jsonl_sink_streams_every_tick(tmp_path):
    path = tmp_path / "ticks.jsonl"
    eng, done = _run_engine(metrics=f"jsonl:{path}")
    eng.metrics.close()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(lines) == eng.metrics.ticks              # one record per tick
    assert [ln["tick"] for ln in lines] == list(range(len(lines)))
    assert all("queue_depth" in ln and "batch_occupancy" in ln
               for ln in lines)
    assert lines[-1]["finished_total"] == len(done)


def test_sink_crash_isolation():
    """A sink that raises on every write does not disturb serving: the run
    completes, the error is counted once, the sink degrades to a NullSink
    and the streams equal a clean engine's."""

    class BoomSink:
        def write(self, records):
            raise IOError("disk full")

        def close(self):
            pass

    m = Metrics(sink=BoomSink(), flush_every=1)
    eng, done = _run_engine(metrics=m)
    assert len(done) == 4
    assert all(r.finish_reason == "length" for r in done)
    assert eng.metrics.sink_errors == 1
    assert isinstance(eng.metrics.sink, NullSink)
    _, done_clean = _run_engine()
    assert ([r.out for r in sorted(done, key=lambda r: r.rid)]
            == [r.out for r in sorted(done_clean, key=lambda r: r.rid)])


@pytest.mark.parametrize("eng_kw", [
    {}, {"kv_quant": True}, {"kv_layout": "paged", "block_size": 8},
    {"kv_layout": "paged", "block_size": 4, "num_blocks": 5},
], ids=["ring", "ring-int8", "paged", "paged-pressure"])
def test_metrics_consistent_with_engine_stats(eng_kw):
    eng, done = _run_engine(**eng_kw)
    assert len(done) == 4
    ms = eng.metrics.summary()
    n_first = sum(1 for r in done if r.ttft is not None)
    assert ms["ttft_s"]["count"] == n_first == len(done)
    assert ms["itl_s"]["count"] == sum(len(r.itl) for r in done)
    assert ms["counters"]["finished_requests"] == len(done)
    assert ms["counters"]["finish_length"] == len(done)
    g = ms["gauges"]
    assert g["finished_total"]["last"] == len(done)
    for key in ("prefill_tokens", "decode_tokens", "prefix_hit_tokens",
                "preemptions"):
        assert g[key]["last"] == eng.stats[key], key
    assert 0.0 <= g["batch_occupancy"]["mean"] <= 1.0
    assert ms["ticks"] > 0
    if eng.pool is not None:
        ps = eng.pool_stats()
        assert g["live_blocks"]["last"] == ps["live"]
        assert g["cached_blocks"]["last"] == ps["cached"]
        assert g["free_blocks"]["last"] == eng.pool.free_blocks
    else:
        assert "live_blocks" not in g


@pytest.mark.parametrize("eng_kw", [
    {}, {"kv_layout": "paged", "block_size": 8},
], ids=["ring", "paged"])
def test_itl_attribution_consistent_across_decode_ticks(eng_kw):
    """A window drains m tokens per host visit and the engine attributes
    drain_interval / m to each, so the ITL histogram keeps one observation
    per token at any ``decode_ticks``."""
    eng1, done1 = _run_engine(**eng_kw)
    eng4, done4 = _run_engine(decode_ticks=4, **eng_kw)
    assert len(done1) == len(done4) == 4
    by_rid1 = {r.rid: r for r in done1}
    by_rid4 = {r.rid: r for r in done4}
    for rid in by_rid1:
        r1, r4 = by_rid1[rid], by_rid4[rid]
        assert r1.out == r4.out                          # streams bitwise
        assert len(r4.itl) == len(r1.itl) == len(r1.out) - 1
        assert all(v >= 0.0 for v in r4.itl)
        # max_new=4: the 3 decode tokens drain in one 4-tick window, each
        # at the same share of the drain interval
        assert all(v == pytest.approx(r4.itl[0], abs=1e-5) for v in r4.itl)
    m1, m4 = eng1.metrics.summary(), eng4.metrics.summary()
    want = sum(len(r.out) - 1 for r in done1)
    assert m1["itl_s"]["count"] == m4["itl_s"]["count"] == want
    assert m1["ttft_s"]["count"] == m4["ttft_s"]["count"] == 4
    assert eng4.stats["decode_tokens"] == eng1.stats["decode_tokens"]
    assert eng4.stats["decode_calls"] < eng1.stats["decode_calls"]


def test_spec_counters_under_the_reference_names():
    eng = Engine(PARAMS, CFG, 2, 32, spec_decode=True, draft_k=3,
                 device="cpu")
    for r in range(3):
        eng.submit(Request(rid=r, prompt=[1, 2, 1, 2, 5 + r], max_new=4))
    eng.run(50)
    c = eng.metrics.counters
    for name in ("spec_windows", "spec_draft_tokens", "spec_accepted_tokens",
                 "spec_emitted_tokens"):
        assert c[name] == eng.stats[name] and c[name] > 0, name


def test_rejected_requests_are_counted():
    eng = Engine(PARAMS, CFG, 1, 8, device="cpu")
    eng.submit(Request(rid=0, prompt=list(range(1, 20)), max_new=4))
    done = eng.run(10)
    assert done[0].finish_reason == "rejected"
    ms = eng.metrics.summary()
    assert ms["counters"]["finished_requests"] == 1
    assert ms["counters"]["finish_rejected"] == 1
    assert ms["ttft_s"]["count"] == 0


def test_reset_stats_roundtrips_metrics():
    eng, done = _run_engine()
    assert eng.metrics.ticks > 0
    eng.reset_stats()
    ms = eng.metrics.summary()
    assert ms["ticks"] == 0 and ms["counters"] == {}
    assert ms["ttft_s"]["count"] == 0 and ms["itl_s"]["count"] == 0
    assert ms["gauges"] == {}
    assert all(v == 0 for v in eng.stats.values())
    eng.finished = []
    for r in range(2):
        eng.submit(Request(rid=100 + r, prompt=[1 + r, 2, 3],
                           sampling=SamplingParams(max_new=3, seed=r)))
    done2 = eng.run(60)
    ms = eng.metrics.summary()
    assert ms["ttft_s"]["count"] == len(done2) == 2
    assert ms["counters"]["finished_requests"] == 2
    assert ms["gauges"]["finished_total"]["last"] == 2
