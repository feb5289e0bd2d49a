"""Engine observability of the port: host-side counters, per-tick gauges
and latency histograms behind a buffered, crash-isolated, pluggable sink
(DESIGN.md §10) — the port's own copy of the reference's
``serve/metrics.py``, which imports no JAX but lives in a package that does.

The engine's behaviour (throughput trajectory, prefix-hit rate, preemption
pressure, TTFT/ITL distribution) is observable per window.  Three design
rules, all load-bearing:

* **host-side only** — every value recorded here is a Python int/float the
  engine already holds on the host (scheduler depth, slot occupancy, pool
  allocator counts — summed over the data shards' pools under a mesh —
  and wall-clock deltas).  Nothing reads a device tensor, so metrics add
  no kernel launch and no host↔device sync to a window; under a mesh
  every rank's host state, and so its metrics, are the same.
* **buffered** — per-window records accumulate in a list and reach the
  sink in batches of ``flush_every``, so a slow sink (file, socket)
  amortises instead of stalling every window.
* **crash-isolated** — a sink raising never kills serving.  The first
  sink exception is reported once on stderr, the sink is replaced by
  :class:`NullSink`, and the engine never sees the error; buffered records
  held at that moment are dropped (counted in ``sink_errors``).

Histograms are log-spaced-bucket histograms: ``record`` is O(1), counts are
exact, percentiles are geometric interpolation inside the landing bucket
(≈ one bucket ratio of relative error — see :class:`Histogram`).  The
exact per-request TTFT/ITL lists on :class:`~repro_torch.serve.engine.
Request` remain the precise record; the histograms are the streaming
aggregate.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Union

__all__ = ["Histogram", "Metrics", "NullSink", "StdoutSink", "JsonlSink",
           "SinkBuffer", "make_sink"]


class Histogram:
    """Fixed log-spaced-bucket latency histogram (values in seconds).

    ``n_buckets`` geometric buckets span [lo, hi); values below ``lo`` land
    in an underflow bucket, values ≥ ``hi`` in an overflow bucket.  With
    the defaults (10 µs … 1000 s over 96 buckets) each bucket spans a
    ratio of ``(1e8)**(1/96) ≈ 1.21``, so percentiles carry ≤ ~21%
    relative error — plenty for trajectory tracking; exact values stay on
    the Request objects.  ``count``/``sum``/``max`` are exact.
    """

    def __init__(self, lo: float = 1e-5, hi: float = 1e3,
                 n_buckets: int = 96):
        if not (0 < lo < hi) or n_buckets <= 0:
            raise ValueError("need 0 < lo < hi and n_buckets > 0")
        self.lo, self.hi, self.n_buckets = float(lo), float(hi), n_buckets
        self._log_lo = math.log(lo)
        self._log_span = math.log(hi) - math.log(lo)
        # counts[0] = underflow, counts[1..n] = buckets, counts[n+1] = overflow
        self.counts = [0] * (n_buckets + 2)
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def _bucket(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return self.n_buckets + 1
        frac = (math.log(v) - self._log_lo) / self._log_span
        return 1 + min(self.n_buckets - 1, int(frac * self.n_buckets))

    def _edge(self, i: int) -> float:
        """Upper edge of counts-index ``i`` (underflow edge = lo)."""
        if i <= 0:
            return self.lo
        if i > self.n_buckets:
            return self.max
        return math.exp(self._log_lo + self._log_span * i / self.n_buckets)

    def record(self, v: float) -> None:
        v = float(v)
        self.counts[self._bucket(v)] += 1
        self.count += 1
        self.sum += v
        if v > self.max:
            self.max = v

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]): geometric
        interpolation inside the bucket where the cumulative count crosses
        the target rank.  0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        target = q / 100.0 * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo_edge = self._edge(i - 1) if i else 0.0
                hi_edge = self._edge(i)
                frac = (target - seen) / c
                if lo_edge <= 0.0:
                    return hi_edge * frac
                return math.exp(math.log(lo_edge)
                                + frac * (math.log(hi_edge)
                                          - math.log(lo_edge)))
            seen += c
        return self.max

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.sum,
                "mean": self.sum / self.count if self.count else 0.0,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99), "max": self.max}

    def state(self) -> dict:
        """JSON-able full state (exact counts, not the percentile summary):
        engine snapshots carry this so a restored engine's histograms keep
        accumulating where the crashed one stopped (DESIGN.md §12)."""
        return {"lo": self.lo, "hi": self.hi, "n_buckets": self.n_buckets,
                "counts": list(self.counts), "count": self.count,
                "sum": self.sum, "max": self.max}

    @classmethod
    def from_state(cls, state: dict) -> "Histogram":
        h = cls(state["lo"], state["hi"], state["n_buckets"])
        h.counts = [int(c) for c in state["counts"]]
        h.count = int(state["count"])
        h.sum = float(state["sum"])
        h.max = float(state["max"])
        return h


# --------------------------------------------------------------------- sinks


class NullSink:
    """Swallows everything — the default: collection without streaming."""

    def write(self, records: List[dict]) -> None:
        pass

    def close(self) -> None:
        pass


class StdoutSink:
    """One compact JSON line per record to a stream (default stdout)."""

    def __init__(self, stream=None):
        self.stream = stream

    def write(self, records: List[dict]) -> None:
        stream = self.stream or sys.stdout
        for rec in records:
            stream.write(json.dumps(rec, separators=(",", ":")) + "\n")

    def close(self) -> None:
        pass


class JsonlSink:
    """Appends records to a JSONL file, one object per line.  The file is
    opened lazily on first flush and kept open across flushes.

    Durability contract: ``close()`` flushes **and fsyncs** so a clean
    shutdown leaves every record on disk, and the lazy open repairs a torn
    final line (a crash mid-``write`` can leave a partial JSON object with
    no trailing newline) by truncating back to the last complete line —
    downstream jsonl readers never see a corrupt tail after a reopen.
    """

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def _repair_torn_tail(self) -> None:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size == 0:
            return
        with open(self.path, "rb+") as fh:
            # Scan backwards in chunks for the last newline; everything
            # after it is a torn partial record from a crashed writer.
            pos, chunk = size, 4096
            last_nl = -1
            while pos > 0 and last_nl < 0:
                start = max(0, pos - chunk)
                fh.seek(start)
                buf = fh.read(pos - start)
                nl = buf.rfind(b"\n")
                if nl >= 0:
                    last_nl = start + nl
                pos = start
            fh.truncate(last_nl + 1 if last_nl >= 0 else 0)

    def write(self, records: List[dict]) -> None:
        if self._fh is None:
            self._repair_torn_tail()
            self._fh = open(self.path, "a")
        for rec in records:
            self._fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None


def make_sink(spec: Union[None, str, object]):
    """Resolve a sink spec: ``None``/``"null"`` → :class:`NullSink`,
    ``"stdout"`` → :class:`StdoutSink`, ``"jsonl:<path>"`` (or a bare
    ``*.jsonl`` path) → :class:`JsonlSink`, and any object with a
    ``write`` method passes through unchanged."""
    if spec is None or spec == "null":
        return NullSink()
    if isinstance(spec, str):
        if spec == "stdout":
            return StdoutSink()
        if spec.startswith("jsonl:"):
            return JsonlSink(spec[len("jsonl:"):])
        if spec.endswith(".jsonl"):
            return JsonlSink(spec)
        raise ValueError(f"unknown metrics sink spec {spec!r}; expected "
                         "'null', 'stdout', 'jsonl:<path>' or a sink object")
    if hasattr(spec, "write"):
        return spec
    raise TypeError(f"not a metrics sink: {spec!r}")


class SinkBuffer:
    """Buffered, crash-isolated front end shared by every record stream
    (:class:`Metrics` and :class:`repro_torch.serve.trace.Tracer`).

    Records accumulate in a list and reach the sink in batches of
    ``flush_every``.  A sink exception is counted in ``sink_errors``,
    reported once on stderr, and the sink is swapped for a
    :class:`NullSink` — the producer never sees the error (the records of
    the failing flush are dropped: best-effort observability).
    """

    def __init__(self, sink, flush_every: int = 64):
        self.sink = sink if hasattr(sink, "write") else make_sink(sink)
        self.flush_every = max(1, int(flush_every))
        self.sink_errors = 0
        self._warned = False
        self._buffer: List[dict] = []

    def add(self, rec: dict) -> None:
        self._buffer.append(rec)
        if len(self._buffer) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if not self._buffer:
            return
        records, self._buffer = self._buffer, []
        if isinstance(self.sink, NullSink):
            return
        try:
            self.sink.write(records)
        except Exception as e:                       # noqa: BLE001
            self.sink_errors += 1
            if not self._warned:
                self._warned = True
                print(f"metrics sink failed ({type(e).__name__}: {e}); "
                      "disabling sink — serving continues without streaming",
                      file=sys.stderr)
            self.sink = NullSink()

    def close(self) -> None:
        self.flush()
        try:
            self.sink.close()
        except Exception:                            # noqa: BLE001
            self.sink_errors += 1

    def clear(self) -> None:
        self._buffer = []


# ----------------------------------------------------------------- collector


class Metrics:
    """The engine's metrics surface: monotonic counters, per-tick gauge
    records, TTFT/ITL histograms, and the buffered sink.

    The engine calls :meth:`tick` once per :meth:`~repro_torch.serve.
    engine.Engine.step` with the host-side gauges of that tick; counters and
    histogram observations arrive from the emit/finish paths.  ``reset``
    zeroes everything (``Engine.reset_stats`` round-trips through it so
    benchmark warm-up waves never leak into measured histograms).
    """

    def __init__(self, sink: Union[None, str, object] = None,
                 flush_every: int = 64):
        self._sb = SinkBuffer(make_sink(sink), flush_every=flush_every)
        self.reset()

    # The sink plumbing lives in the shared SinkBuffer; these properties
    # keep the original public surface (tests read metrics.sink /
    # metrics.sink_errors directly).
    @property
    def sink(self):
        return self._sb.sink

    @property
    def sink_errors(self) -> int:
        return self._sb.sink_errors

    @property
    def flush_every(self) -> int:
        return self._sb.flush_every

    # -- lifecycle

    def reset(self) -> None:
        self.counters: Dict[str, float] = {}
        self.ttft_s = Histogram()
        self.itl_s = Histogram()
        self.ticks = 0
        self._sb.clear()
        self._gauge_sum: Dict[str, float] = {}
        self._gauge_last: Dict[str, float] = {}
        self._gauge_n: Dict[str, int] = {}

    def close(self) -> None:
        self._sb.close()

    # -- recording (all host-side; never touches a device array)

    def inc(self, name: str, v: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + v

    def observe_ttft(self, seconds: float) -> None:
        self.ttft_s.record(seconds)

    def observe_itl(self, seconds: float) -> None:
        """One observation **per completed token**, not per host drain: a
        windowed-decode engine draining m tokens at once must attribute
        drain_interval / m to each (the engine's window drain does
        exactly that), so the itl histogram's count matches the token count
        at any decode_ticks setting (tests/test_torch_metrics.py)."""
        self.itl_s.record(seconds)

    def tick(self, **gauges) -> None:
        """Record one per-tick gauge snapshot and buffer it for the sink."""
        rec = {"t": time.time(), "tick": self.ticks}
        for k, v in gauges.items():
            rec[k] = v
            if isinstance(v, (int, float)):
                self._gauge_sum[k] = self._gauge_sum.get(k, 0.0) + v
                self._gauge_n[k] = self._gauge_n.get(k, 0) + 1
                self._gauge_last[k] = v
        self.ticks += 1
        self._sb.add(rec)

    def event(self, kind: str, **fields) -> None:
        """Buffer one out-of-band event record for the sink (same stream as
        the tick records, distinguished by an ``event`` key).  The engine's
        lifecycle events (degraded/restored/slow_window) travel on the
        tracer's feed instead (DESIGN.md §13); this remains for ad-hoc
        callers that want events interleaved with gauges."""
        rec = {"t": time.time(), "event": kind}
        rec.update(fields)
        self._sb.add(rec)

    # -- sink plumbing

    def flush(self) -> None:
        """Hand the buffered records to the sink (crash-isolated — see
        :class:`SinkBuffer`)."""
        self._sb.flush()

    # -- snapshot / restore (crash recovery, DESIGN.md §12)

    def snapshot(self) -> dict:
        """JSON-able aggregate state: counters, tick count, gauge
        aggregates and full histogram states.  The sink buffer is *not*
        captured — buffered-but-unflushed records are exactly the
        observability loss the crash-isolation contract already permits."""
        return {
            "counters": dict(self.counters),
            "ticks": self.ticks,
            "gauge_sum": dict(self._gauge_sum),
            "gauge_last": dict(self._gauge_last),
            "gauge_n": dict(self._gauge_n),
            "ttft_s": self.ttft_s.state(),
            "itl_s": self.itl_s.state(),
        }

    def restore(self, snap: dict) -> None:
        """Resume accumulation from a :meth:`snapshot` (sink and
        ``flush_every`` keep this instance's configuration)."""
        self.counters = {k: v for k, v in snap["counters"].items()}
        self.ticks = int(snap["ticks"])
        self._gauge_sum = {k: float(v) for k, v in snap["gauge_sum"].items()}
        self._gauge_last = dict(snap["gauge_last"])
        self._gauge_n = {k: int(v) for k, v in snap["gauge_n"].items()}
        self.ttft_s = Histogram.from_state(snap["ttft_s"])
        self.itl_s = Histogram.from_state(snap["itl_s"])
        self._sb.clear()

    # -- reading

    def gauge_mean(self, name: str) -> float:
        n = self._gauge_n.get(name, 0)
        return self._gauge_sum.get(name, 0.0) / n if n else 0.0

    def gauge_last(self, name: str) -> Optional[float]:
        return self._gauge_last.get(name)

    def summary(self) -> dict:
        """One JSON-able snapshot: counters, tick count, per-gauge
        mean/last, and the TTFT/ITL histogram summaries."""
        return {
            "ticks": self.ticks,
            "counters": dict(self.counters),
            "gauges": {k: {"mean": self.gauge_mean(k),
                           "last": self._gauge_last[k]}
                       for k in sorted(self._gauge_last)},
            "ttft_s": self.ttft_s.summary(),
            "itl_s": self.itl_s.summary(),
            "sink_errors": self.sink_errors,
        }
