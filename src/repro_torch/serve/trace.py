"""Per-request tracing and latency attribution of the port (DESIGN.md §13):
the port's own copy of the reference's ``serve/trace.py``.

The tracer is a host-only span/event recorder threaded through the serving
engine's request lifecycle.  It takes ``time.time()`` stamps exclusively at
points where the engine already synchronises with the device (submit,
admission, prefill calls, window drains, preempt/resume, finish), so
enabling it adds no kernel launch and no host↔device sync and cannot
perturb the token stream.

Three export surfaces share one record stream:

- a streaming jsonl event feed through the crash-isolated sink machinery
  from :mod:`repro_torch.serve.metrics` (``SinkBuffer``),
- a Chrome-trace/Perfetto JSON export (``perfetto()`` / ``write_perfetto()``)
  with per-request tracks (pid 1, one thread per rid) and engine tracks
  (pid 0: waves, counters, degradation instants),
- ``explain(rid)`` — a latency-attribution report decomposing a request's
  wall time into queue / prefill / decode / preempt_stall / degraded /
  recovery shares that sum to 100% by construction.

Attribution-by-construction invariant: each request owns a list of *phase
segments* that exactly partition ``[t_submit, t_finish]`` — every lifecycle
transition closes the open segment at time ``t`` and opens the next one at
the same ``t``.  Spans open at crash time are closed by ``restore()`` with a
``recovery`` marker and a ``recovery`` segment bridges the gap to resume, so
timelines stay continuous (and still sum to 100%) across snapshot/restore.

Cold-start stalls and launch choices: an enabled tracer observes the
port's own — a CUDA kernel library built by ``nvcc`` (``kernels/_build.py``)
and a decode window's CUDA-graph capture (``serve/graphs.py``), as
``kernel_build`` and ``graph_capture`` events with their seconds — and, as
the reference's does, the kernel autotuner's (``kernels/autotune.py``):
``autotune_model_pick``, ``autotune_cache_hit`` and ``autotune_sweep``
events with their keys, blocks and sweep seconds, so they show in the
timeline.
"""

from __future__ import annotations

import json
import os
import time

from repro_torch import coldstart
from repro_torch.kernels import autotune
from repro_torch.serve.metrics import SinkBuffer, make_sink

__all__ = ["Tracer", "format_explain"]

# Lifecycle phases a request moves through.  ``queued`` covers both initial
# queue wait and requeued wait after a preempt-stall; ``recovery`` only
# appears on timelines that crossed a snapshot/restore.
PHASES = ("queued", "prefill", "decode", "preempt_stall", "recovery")

# explain() buckets.  ``queued`` reports as ``queue``; prefill/decode
# segments overlapping a degradation interval report as ``degraded``.
CATEGORIES = ("queue", "prefill", "decode", "preempt_stall", "degraded", "recovery")

_PHASE_TO_CATEGORY = {"queued": "queue"}


class _ReqTrace:
    """Per-request span state: closed segments + at most one open segment."""

    __slots__ = ("rid", "t0", "segments", "open", "done", "reason", "tags")

    def __init__(self, rid, t0):
        self.rid = rid
        self.t0 = float(t0)
        self.segments = []  # [phase, t_start, t_end, degraded(0/1)]
        self.open = None  # [phase, t_start, degraded(0/1), tags dict]
        self.done = False
        self.reason = None
        self.tags = {}  # latest request metadata (slot, shard, ...)

    def state(self):
        return {
            "rid": self.rid,
            "t0": self.t0,
            "segments": [list(s) for s in self.segments],
            "open": list(self.open[:3]) + [dict(self.open[3])] if self.open else None,
            "done": self.done,
            "reason": self.reason,
            "tags": dict(self.tags),
        }

    @classmethod
    def from_state(cls, st):
        tr = cls(st["rid"], st["t0"])
        tr.segments = [list(s) for s in st["segments"]]
        op = st.get("open")
        tr.open = [op[0], op[1], op[2], dict(op[3])] if op else None
        tr.done = bool(st.get("done"))
        tr.reason = st.get("reason")
        tr.tags = dict(st.get("tags") or {})
        return tr


class Tracer:
    """Span/event tracer for the serving engine (DESIGN.md §13).

    Construct via :meth:`from_spec` (what ``Engine(trace=...)`` and the
    ``--trace`` flag do).  A disabled tracer (``enabled=False``) turns every
    method into an early-return no-op so the untraced hot path stays free.
    """

    def __init__(self, sink=None, perfetto_path=None, *, enabled=True,
                 retain=None, flush_every=64):
        self.enabled = bool(enabled)
        self.perfetto_path = perfetto_path
        # Retain records in memory when a Perfetto export (or explicit "mem"
        # mode) needs them; a pure jsonl feed streams without retention.
        if retain is None:
            retain = perfetto_path is not None or sink is None
        self._retain = bool(retain)
        self._retained = []
        self._sb = SinkBuffer(make_sink(sink), flush_every=flush_every)
        self._reqs = {}
        self._degraded = False
        if self.enabled:
            # held weakly: a dropped tracer unregisters itself
            coldstart.register_observer(self)
            autotune.register_observer(self)

    # ------------------------------------------------------------- spec --
    @classmethod
    def from_spec(cls, spec):
        """Build a tracer from a ``--trace`` spec.

        ``None`` → disabled.  Strings are comma-combinable parts:
        ``mem`` (retain records in memory), ``perfetto:<path>`` (write a
        Chrome-trace JSON on close), ``jsonl:<path>`` / ``<path>.jsonl``
        (stream records through a JsonlSink), ``stdout``, ``null``.  An
        object with a ``write`` method is used as the sink directly, and an
        existing :class:`Tracer` passes through.
        """
        if spec is None:
            return cls(enabled=False)
        if isinstance(spec, Tracer):
            return spec
        if isinstance(spec, str):
            sink_spec, perfetto, mem = None, None, False
            for part in spec.split(","):
                part = part.strip()
                if not part:
                    continue
                if part == "mem":
                    mem = True
                elif part.startswith("perfetto:"):
                    perfetto = part[len("perfetto:"):]
                elif part in ("null", "stdout") or part.startswith("jsonl:") \
                        or part.endswith(".jsonl"):
                    sink_spec = part
                else:
                    raise ValueError(f"unknown trace spec part: {part!r}")
            return cls(sink=sink_spec, perfetto_path=perfetto,
                       retain=True if (mem or perfetto) else None)
        if hasattr(spec, "write"):
            return cls(sink=spec)
        raise TypeError(f"cannot build a Tracer from {type(spec).__name__}")

    # -------------------------------------------------------- internals --
    @property
    def sink(self):
        return self._sb.sink

    @property
    def sink_errors(self):
        return self._sb.sink_errors

    def records(self):
        """Retained records (requires "mem" or perfetto mode)."""
        return list(self._retained)

    def _rec(self, rec):
        if self._retain:
            self._retained.append(rec)
        self._sb.add(rec)

    def _req(self, rid, t):
        tr = self._reqs.get(rid)
        if tr is None or tr.done:
            # Unknown rid (e.g. instrumentation reached before begin(), or a
            # finished rid being reused): start a fresh timeline rather than
            # corrupting the old one.
            tr = _ReqTrace(rid, t)
            self._reqs[rid] = tr
        return tr

    def _open(self, tr, phase, t, tags):
        deg = 1 if (self._degraded and phase in ("prefill", "decode")) else 0
        tr.open = [phase, float(t), deg, dict(tags)]

    def _close_open(self, tr, t, **marks):
        if tr.open is None:
            return
        phase, t_start, deg, tags = tr.open
        t_end = max(float(t), t_start)  # clock skew guard: keep segments monotone
        tr.segments.append([phase, t_start, t_end, deg])
        tr.open = None
        rec = {"kind": "span", "cat": "phase", "name": phase, "rid": tr.rid,
               "t0": t_start, "t1": t_end}
        if deg:
            rec["degraded"] = 1
        rec.update(tags)
        rec.update(marks)
        self._rec(rec)

    # ------------------------------------------------- lifecycle methods --
    def begin(self, rid, t, **tags):
        """Request submitted: open its ``queued`` span at ``t``."""
        if not self.enabled:
            return
        tr = self._reqs.get(rid)
        if tr is not None and not tr.done:
            return  # already live (e.g. restored timeline); keep it
        tr = _ReqTrace(rid, t)
        self._reqs[rid] = tr
        tr.tags.update(tags)
        self._open(tr, "queued", t, {})
        self._rec({"kind": "event", "name": "submit", "rid": rid,
                   "t": float(t), **tags})

    def phase(self, rid, name, t, **tags):
        """Transition ``rid`` to phase ``name`` at ``t`` (closes open span)."""
        if not self.enabled:
            return
        tr = self._req(rid, t)
        tr.tags.update(tags)
        self._close_open(tr, t)
        self._open(tr, name, t, tags)

    def finish(self, rid, t, reason, **tags):
        """Request retired (eos/stop/length/shed/deadline/...): seal timeline."""
        if not self.enabled:
            return
        tr = self._req(rid, t)
        tr.tags.update(tags)
        self._close_open(tr, t, finish_reason=reason)
        tr.done = True
        tr.reason = reason
        self._rec({"kind": "event", "name": "finish", "rid": rid,
                   "t": float(t), "reason": reason, **tags})

    def set_degraded(self, flag, t):
        """Degradation watermark flipped: rotate open prefill/decode spans so
        time under degradation is attributed to the ``degraded`` bucket."""
        if not self.enabled:
            return
        flag = bool(flag)
        if flag == self._degraded:
            return
        self._degraded = flag
        want = 1 if flag else 0
        for tr in self._reqs.values():
            if tr.done or tr.open is None:
                continue
            phase = tr.open[0]
            if phase in ("prefill", "decode") and tr.open[2] != want:
                tags = tr.open[3]
                self._close_open(tr, t)
                self._open(tr, phase, t, tags)

    # ------------------------------------------------- engine-side feeds --
    def event(self, name, t=None, rid=None, **fields):
        """Instant event (degraded/restored/slow_window/shed/pool provenance/...)."""
        if not self.enabled:
            return
        rec = {"kind": "event", "name": name,
               "t": float(t) if t is not None else time.time()}
        if rid is not None:
            rec["rid"] = rid
        rec.update(fields)
        self._rec(rec)

    def wave(self, name, t0, t1, parts=(), **tags):
        """Engine-track span for a batched dispatch (prefill wave / decode
        window), plus fine-grained detail spans on each participating
        request's track.  ``parts`` is ``[(rid, span_name, tags), ...]``.
        Timestamps are the ones the engine already took around the dispatch.
        """
        if not self.enabled:
            return
        t0, t1 = float(t0), max(float(t1), float(t0))
        self._rec({"kind": "span", "cat": "wave", "name": name, "rid": None,
                   "t0": t0, "t1": t1, "n": len(parts), **tags})
        for rid, sname, stags in parts:
            self._rec({"kind": "span", "cat": "wave", "name": sname,
                       "rid": rid, "t0": t0, "t1": t1, **(stags or {})})

    def counters(self, t=None, **gauges):
        """Engine counter sample (queue depth, live blocks, degraded, ...)."""
        if not self.enabled or not gauges:
            return
        self._rec({"kind": "counter",
                   "t": float(t) if t is not None else time.time(), **gauges})

    # ------------------------------------------------ cold-start observer --
    def coldstart_event(self, kind, **fields):
        """Observer hook for the port's cold-start stalls: ``kernel_build``
        (a kernel library compiled, with its seconds) and ``graph_capture``
        (a decode window captured as a CUDA graph, with its seconds), so
        they show up in the timeline."""
        self.event(kind, **fields)

    def autotune_event(self, kind, **fields):
        """Observer hook for the kernel autotuner's winner cache: a model
        pick, a cache hit (with the block) or a measured sweep (winner,
        candidates, recompute, seconds), as the reference's tracer gets
        them."""
        self.event(kind, **fields)

    # ------------------------------------------------------ attribution --
    def explain(self, rid, now=None):
        """Latency-attribution report for ``rid``.

        Returns a dict with ``wall_s``, per-category ``seconds`` and
        ``shares`` (fractions of wall; sum to 1.0 for any wall > 0), the
        ``dominant`` category, ``finish_reason``, and the raw ``segments``.
        Live requests are attributed up to ``now``.
        """
        tr = self._reqs[rid]
        segs = [list(s) for s in tr.segments]
        if tr.open is not None:
            t = float(now) if now is not None else time.time()
            phase, t_start, deg, _tags = tr.open
            segs.append([phase, t_start, max(t, t_start), deg])
        t_end = segs[-1][2] if segs else tr.t0
        wall = t_end - tr.t0
        seconds = {c: 0.0 for c in CATEGORIES}
        for phase, a, b, deg in segs:
            cat = "degraded" if deg else _PHASE_TO_CATEGORY.get(phase, phase)
            seconds[cat] += b - a
        shares = {c: (v / wall if wall > 0 else 0.0) for c, v in seconds.items()}
        dominant = max(CATEGORIES, key=lambda c: seconds[c]) if wall > 0 else "queue"
        return {
            "rid": rid,
            "done": tr.done,
            "finish_reason": tr.reason,
            "wall_s": wall,
            "seconds": seconds,
            "shares": shares,
            "dominant": dominant,
            "tags": dict(tr.tags),
            "segments": [
                {"phase": p, "t0": a, "t1": b, "degraded": bool(d)}
                for p, a, b, d in segs
            ],
        }

    def request_ids(self):
        return list(self._reqs)

    # ------------------------------------------------ snapshot / restore --
    def snapshot(self, t=None):
        """JSON-able trace state, carried inside the engine snapshot."""
        if not self.enabled:
            return None
        return {
            "t": float(t) if t is not None else time.time(),
            "degraded": 1 if self._degraded else 0,
            "requests": [tr.state() for tr in self._reqs.values()],
        }

    def restore(self, snap, t=None):
        """Resume the timelines carried by an engine snapshot.

        Spans open at crash time are closed at the snapshot stamp with a
        ``recovery`` marker, a ``recovery`` segment bridges crash → resume,
        and the original phase reopens at ``t`` — so restored requests keep
        one continuous, fully-attributed timeline.
        """
        if not self.enabled or not snap:
            return
        t_resume = float(t) if t is not None else time.time()
        t_snap = min(float(snap["t"]), t_resume)
        self._degraded = bool(snap.get("degraded"))
        self._reqs = {}
        reopened = 0
        for st in snap.get("requests", []):
            tr = _ReqTrace.from_state(st)
            self._reqs[tr.rid] = tr
            if self._retain:
                # Re-inject carried segments so a post-restore Perfetto
                # export shows the full pre-crash timeline.  These are NOT
                # re-sent to the jsonl sink: the pre-crash process already
                # streamed them.
                for phase, a, b, deg in tr.segments:
                    rec = {"kind": "span", "cat": "phase", "name": phase,
                           "rid": tr.rid, "t0": a, "t1": b, "carried": 1}
                    if deg:
                        rec["degraded"] = 1
                    self._retained.append(rec)
            if tr.open is not None and not tr.done:
                phase, _t_start, _deg, tags = tr.open
                self._close_open(tr, t_snap, recovery=1)
                tr.segments.append(["recovery", t_snap, t_resume, 0])
                self._rec({"kind": "span", "cat": "phase", "name": "recovery",
                           "rid": tr.rid, "t0": t_snap, "t1": t_resume})
                self._open(tr, phase, t_resume, tags)
                reopened += 1
        self.event("recovery", t=t_resume, t_snap=t_snap, reopened=reopened)

    # ---------------------------------------------------------- exports --
    def perfetto(self):
        """Chrome-trace JSON (``{"traceEvents": [...]}``) from retained
        records.  pid 0 = engine tracks (waves, counters, instants),
        pid 1 = per-request tracks (tid = rid).  Load in ui.perfetto.dev.
        """
        times = [r["t0"] for r in self._retained if "t0" in r]
        times += [r["t"] for r in self._retained if "t" in r]
        times += [tr.t0 for tr in self._reqs.values()]
        base = min(times) if times else 0.0

        def us(t):
            return (t - base) * 1e6

        events = [
            {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
             "args": {"name": "engine"}},
            {"ph": "M", "pid": 0, "tid": 0, "name": "thread_name",
             "args": {"name": "engine"}},
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "requests"}},
        ]
        named = set()
        for rec in self._retained:
            rid = rec.get("rid")
            if rid is not None and rid not in named:
                named.add(rid)
                events.append({"ph": "M", "pid": 1, "tid": rid,
                               "name": "thread_name",
                               "args": {"name": f"req {rid}"}})
            if rec["kind"] == "span":
                pid, tid = (1, rid) if rid is not None else (0, 0)
                args = {k: v for k, v in rec.items()
                        if k not in ("kind", "cat", "name", "rid", "t0", "t1")}
                events.append({
                    "ph": "X", "pid": pid, "tid": tid, "name": rec["name"],
                    "cat": rec.get("cat", "span"), "ts": us(rec["t0"]),
                    "dur": max(0.0, (rec["t1"] - rec["t0"]) * 1e6),
                    "args": args,
                })
            elif rec["kind"] == "event":
                pid, tid = (1, rid) if rid is not None else (0, 0)
                args = {k: v for k, v in rec.items()
                        if k not in ("kind", "name", "rid", "t")}
                events.append({
                    "ph": "i", "pid": pid, "tid": tid, "name": rec["name"],
                    "ts": us(rec["t"]), "s": "t" if rid is not None else "p",
                    "args": args,
                })
            elif rec["kind"] == "counter":
                for k, v in rec.items():
                    if k in ("kind", "t"):
                        continue
                    events.append({
                        "ph": "C", "pid": 0, "tid": 0, "name": k,
                        "ts": us(rec["t"]), "args": {"value": v},
                    })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_perfetto(self, path=None):
        path = path or self.perfetto_path
        if path is None:
            raise ValueError("no perfetto path configured")
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:
            json.dump(self.perfetto(), fh)
        os.replace(tmp, path)
        return path

    # -------------------------------------------------------- plumbing --
    def flush(self):
        if self.enabled:
            self._sb.flush()

    def close(self):
        """Flush the jsonl feed and write the Perfetto export, if any."""
        if not self.enabled:
            return
        self._sb.close()
        if self.perfetto_path:
            self.write_perfetto(self.perfetto_path)


def format_explain(report):
    """One-line human rendering of an ``explain()`` report."""
    shares = " ".join(
        f"{cat}={100.0 * report['shares'][cat]:.1f}%"
        for cat in CATEGORIES
        if report["seconds"][cat] > 0.0
    )
    reason = report["finish_reason"] or ("live" if not report["done"] else "?")
    return (f"req {report['rid']}: wall={report['wall_s'] * 1e3:.1f}ms "
            f"dominant={report['dominant']} [{reason}] {shares}")
