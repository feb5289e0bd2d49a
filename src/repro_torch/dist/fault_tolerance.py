"""Fault tolerance for long runs: failure injection (tests/chaos), a
straggler watchdog, and restart-from-snapshot loops — the port's own
copy of the reference's ``dist/fault_tolerance.py`` (DESIGN.md §12).

Two consumers share these primitives:

* **training** — a training loop calls ``injector.maybe_fail(step, phase)``
  at its failure points; ``run_with_restarts`` re-enters the loop after a
  crash and the loop resumes from its latest checkpoint;
* **serving** — the engine calls the same injector at its five serve crash
  points ('pre_admit', 'pool_alloc', 'mid_window', 'post_drain',
  'sink_write'), keyed on the engine tick at the start of the window;
  ``run_serve_with_restarts`` builds a fresh engine after each crash and
  restores it from the latest ``Engine.snapshot`` file.  Because dither KV
  codes are position-pure and the sampler is a stateless hash of (seed,
  counter), the restored engine's streams are bit for bit those of an
  uninterrupted run (tests/test_torch_serve_fault.py).

Two departures from the reference, both about what a restart may hide:
the restart loops catch :class:`InjectedFailure` only — any other error is
a fault of the program and propagates at once — and before the next
attempt they drop the crashed attempt's frames and collect, so a crashed
engine (its cache and its CUDA-graph pools) is freed before the fresh one
captures graphs.
"""

from __future__ import annotations

import gc
import json
import os
import traceback
from typing import Callable, Dict, Optional, Set, Tuple

__all__ = [
    "InjectedFailure", "FailureInjector", "StragglerWatchdog",
    "run_with_restarts", "run_serve_with_restarts", "SERVE_PHASES",
]

# the engine's injection points, in within-step order (DESIGN.md §12)
SERVE_PHASES = ("pre_admit", "pool_alloc", "mid_window", "post_drain",
                "sink_write")


class InjectedFailure(RuntimeError):
    """A deliberately injected crash (never raised in production runs)."""


class FailureInjector:
    """Crashes the run at configured (step, phase) points, once per point.

    ``crash_at`` maps step → phase name.  ``fired`` records points that
    already crashed so a resumed run sails past them — the
    restart-converges contract.
    """

    def __init__(self, crash_at: Optional[Dict[int, str]] = None):
        self.crash_at: Dict[int, str] = dict(crash_at or {})
        self.fired: Set[Tuple[int, str]] = set()

    def maybe_fail(self, step: int, phase: str) -> None:
        if self.crash_at.get(step) == phase and (step, phase) not in self.fired:
            self.fired.add((step, phase))
            raise InjectedFailure(f"injected failure at step {step} ({phase})")


class StragglerWatchdog:
    """Flags steps whose wall time exceeds ``threshold`` × the running mean.

    Flagged steps are excluded from the baseline so one straggler does not
    mask the next.  The first ``warmup`` observations only build the baseline.
    """

    def __init__(self, threshold: float = 3.0, warmup: int = 3):
        self.threshold = float(threshold)
        self.warmup = int(warmup)
        self._times: list = []
        self.flagged: Set[int] = set()

    def observe(self, step: int, seconds: float) -> bool:
        baseline_ready = len(self._times) >= self.warmup
        if baseline_ready:
            mean = sum(self._times) / len(self._times)
            if seconds > self.threshold * mean:
                self.flagged.add(step)
                return True
        self._times.append(seconds)
        return False


def run_with_restarts(loop: Callable[[int], object], max_restarts: int = 3):
    """Run ``loop(restart_idx)`` to completion, restarting after an
    :class:`InjectedFailure`.

    Returns the loop's result.  After ``max_restarts`` failed restarts the
    last crash is chained into a RuntimeError (unrecoverable job).  Before
    each restart the crashed attempt's frames are cleared and the garbage
    collector runs, so what the attempt built is freed first.
    """
    last_exc: Optional[BaseException] = None
    for restart_idx in range(max_restarts + 1):
        try:
            return loop(restart_idx)
        except InjectedFailure as exc:
            traceback.clear_frames(exc.__traceback__)
            last_exc = exc
        gc.collect()
    raise RuntimeError(
        f"job failed after {max_restarts} restarts"
    ) from last_exc


def run_serve_with_restarts(make_engine: Callable[[], object],
                            submit: Callable[[object], None], *,
                            snapshot_path: str, ticks: int,
                            max_restarts: int = 3,
                            streams: Optional[dict] = None):
    """Crash-tolerant serve loop (DESIGN.md §12): the serving analogue of
    the training restart loop above.

    Each (re)start builds a **fresh** engine via ``make_engine`` — a crashed
    engine died mid-mutation and must be discarded, never re-driven.  If
    ``snapshot_path`` exists the engine restores from it (``submit`` is NOT
    called again: the snapshot already carries the queue and every
    in-flight request); on a cold start ``submit(engine)`` enqueues the
    workload.  ``streams`` optionally re-attaches per-rid streaming
    callbacks, which snapshots cannot carry.  Returns the engine that ran
    to completion.

    ``make_engine`` should pass the same ``snapshot_path`` to the Engine so
    each window persists a recovery point; it should also share one
    ``FailureInjector`` across restarts — its ``fired`` set is what lets a
    resumed run sail past an already-fired crash point.

    Trace handoff (DESIGN.md §13): when ``make_engine`` enables tracing
    (``Engine(trace=...)``), the snapshot carries every request's span
    timeline, so the restored engine resumes the *same* timelines — spans
    open at crash time are closed with a recovery marker and a ``recovery``
    segment bridges crash → resume.
    """

    def loop(_restart_idx: int):
        engine = make_engine()
        if os.path.exists(snapshot_path):
            with open(snapshot_path) as fh:
                engine.restore(json.load(fh), streams=streams)
        else:
            submit(engine)
        engine.run(ticks)
        return engine

    return run_with_restarts(loop, max_restarts=max_restarts)
