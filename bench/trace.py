"""The traced slice: ``torch.profiler`` over whole engine steps that
follow the window, for a fixed span of seconds and at least one prefill
wave and one decode window, and what the benchmark reads from it.

Device activity is every event the profiler places on the card (kernels,
copies, sets), less the ranges it draws there for host spans. ``busy_s``
is the union of their intervals, ``window_s`` the slice's host wall time
between two synchronisations, so the idle share is 1 − busy / window.
Each idle gap between device intervals is put down to what the host was
doing at its midpoint: the innermost host event there, under the
innermost of the benchmark's own spans (``bench.*``) around it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["Slice", "covers", "profile_steps", "summarise"]


@dataclass
class Slice:
    """What a traced slice left: its host seconds, the device intervals
    (name, start ns, end ns), the host events (name, start, end, is one of
    the benchmark's spans, thread), the loop's state at its two ends, and
    the steps it took."""
    seconds: float
    device: List[Tuple[str, int, int]]
    host: List[Tuple[str, int, int, bool, int]]
    before: Dict = field(default_factory=dict)
    after: Dict = field(default_factory=dict)
    steps: int = 0


def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{which}_us")() * 1000)


def covers(before: Dict, now: Dict) -> bool:
    """Whether the steps between two of the loop's states ran a prefill
    wave and a decode window."""
    return (now["stats"]["prefill_tokens"] > before["stats"]["prefill_tokens"]
            and now["tick"] > before["tick"])


def profile_steps(loop, seconds: float, state, cuda: bool = True,
                  max_steps: int = 10_000) -> Slice:
    """Whole loop steps under the profiler until the slice has lasted
    ``seconds`` and holds a prefill wave and a decode window (so every
    cell's slice spans the same phases of its loop); ``state()`` reads the
    loop's counters (``stats``, ``tick``) before and after.  ``cuda``
    False traces the host alone (the CPU tests)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    before = state()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps = 0
        while steps < max_steps:
            loop.step()
            steps += 1
            if time.perf_counter() - t0 >= seconds \
                    and covers(before, state()):
                break
        sync()
        seconds = time.perf_counter() - t0
    after = state()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + int(e.duration_ns()) if hasattr(e, "duration_ns") \
            else _ns(e, "end")
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # a host span's range on the device's timeline is no operation
            if not (e.is_user_annotation() or e.name().startswith("bench.")):
                device.append((e.name(), start, end))
        else:
            host.append((e.name(), start, end,
                         e.name().startswith("bench."),
                         e.start_thread_id()))
    return Slice(seconds, device, host, before, after, steps)


def _union(intervals: np.ndarray) -> np.ndarray:
    """Disjoint sorted intervals covering (start, end) rows."""
    if not len(intervals):
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, np.int64)


def _host_labels(host, mids: List[int]) -> List[str]:
    """What the host was doing at each of the sorted times ``mids``: the
    innermost event of the loop's thread (the one that opens the
    benchmark's spans) around it, under the innermost of those spans; a
    sweep over the events in start order, which nest on one thread."""
    ours = [h for h in host if h[3]]
    thread = ours[0][4] if ours else None
    events = sorted((h for h in host if thread is None or h[4] == thread),
                    key=lambda h: (h[1], -h[2]))
    labels, stack, i = [], [], 0
    for t in mids:
        while i < len(events) and events[i][1] <= t:
            stack.append(events[i])
            i += 1
        stack = [h for h in stack if h[2] >= t]
        span = next((h[0] for h in reversed(stack) if h[3]), "")
        inner = next((h[0] for h in reversed(stack) if not h[3]), "")
        labels.append(" > ".join(x for x in (span, inner) if x)
                      or "idle host")
    return labels


def summarise(sl: Slice, top: int = 10) -> Dict:
    """busy seconds, the heaviest device operations, and the idle gaps
    summed by what the host was doing (``top`` of each, seconds as
    measured)."""
    iv = np.asarray([(s, e) for _, s, e in sl.device], np.int64)
    busy = _union(iv)
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9
    ops: Dict[str, float] = {}
    for name, s, e in sl.device:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
    gaps = []
    if len(busy) > 1:
        ends, starts = busy[:-1, 1], busy[1:, 0]
        mids = [int(m) for m in (starts + ends) // 2]
        gaps = list(zip(_host_labels(sl.host, mids),
                        ((starts - ends) / 1e9).tolist()))
    by_host: Dict[str, float] = {}
    for name, s in gaps:
        by_host[name] = by_host.get(name, 0.0) + s
    return {
        "busy_s": busy_s,
        "device_ops": sorted(([n[:200], s] for n, s in ops.items()),
                             key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n[:200], s] for n, s in by_host.items()),
                            key=lambda x: -x[1])[:top],
        "op_seconds": ops,
    }
