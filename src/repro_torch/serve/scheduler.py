"""Admission scheduling for the serving engine (DESIGN.md §6): the port's
copy of the reference's ``serve/scheduler.py``, which imports no JAX but
lives in a package that does.

The scheduler owns the QUEUED stage of the request lifecycle; the engine
asks it for up to ``n`` requests whenever decode slots free up and routes
the admitted batch through the prefill step.  Under the paged KV pool the
engine admits *conditionally* — it peeks the head, checks the pool can
supply the blocks, and either pops or stops — and preempted requests
re-enter through :meth:`requeue` with their original arrival order, so a
victim resumes ahead of traffic that arrived after it.

Sharded serving (DESIGN.md §9) keeps this queue *global*: one head-of-line
order across every data shard.  The engine, not the scheduler, picks which
shard serves the head (longest cached prefix, then most free blocks), and
a preempted request can only resume on the shard holding its blocks — the
head then waits for a slot there rather than losing its place in line.

* ``fcfs``     — strict submission order.
* ``priority`` — highest ``Request.priority`` first; submission order
  breaks ties (stable), so equal-priority traffic degrades to FCFS.
"""

from __future__ import annotations

from typing import Any, List, Optional

__all__ = ["Scheduler"]


class Scheduler:
    POLICIES = ("fcfs", "priority")

    def __init__(self, policy: str = "fcfs"):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown scheduling policy {policy!r}; "
                             f"expected one of {self.POLICIES}")
        self.policy = policy
        self._queue: List[Any] = []
        self._arrivals = 0
        self._unsorted = False
        # queue-provenance hook (DESIGN.md §13): when set by a tracing
        # engine, called as on_event(kind, **fields) on enter/requeue so
        # queue churn shows up on the trace timeline; None costs nothing.
        self.on_event = None

    def submit(self, req) -> None:
        req._arrival = self._arrivals
        self._arrivals += 1
        self._queue.append(req)
        self._unsorted = True
        if self.on_event is not None:
            self.on_event("queue_enter", rid=getattr(req, "rid", None),
                          arrival=req._arrival, depth=len(self._queue))

    def requeue(self, req) -> None:
        """Put a preempted request back, keeping its original ``_arrival``
        stamp: within its priority class it sorts *before* anything
        submitted after it, so preemption never costs a request its place
        in line (resume-ordering contract, tests/test_kvpool.py)."""
        assert hasattr(req, "_arrival"), "requeue is for admitted requests"
        self._queue.append(req)
        self._unsorted = True
        if self.on_event is not None:
            self.on_event("queue_requeue", rid=getattr(req, "rid", None),
                          arrival=req._arrival, depth=len(self._queue))

    def __len__(self) -> int:
        return len(self._queue)

    def _sort(self) -> None:
        # FCFS keeps arrival order too — requeued victims must slot back in
        # front of later arrivals, not at the tail.  Sorting is deferred to
        # the next read and skipped while nothing was inserted, so the
        # admission loop's peek-per-request stays O(1) in steady state.
        if self._unsorted:
            self._queue.sort(
                key=lambda r: (-getattr(r, "priority", 0), r._arrival)
                if self.policy == "priority" else r._arrival)
            self._unsorted = False

    def queued(self) -> List[Any]:
        """Snapshot of the queue in policy order (read-only view — the
        engine's deadlock breaker scans it for preempted block-holders)."""
        self._sort()
        return list(self._queue)

    def peek(self) -> Optional[Any]:
        """The request :meth:`admit` would hand out next (None if empty) —
        the paged engine's token-budget gate inspects it before popping."""
        if not self._queue:
            return None
        self._sort()
        return self._queue[0]

    def pop(self, req) -> None:
        """Remove a specific request (the engine admits what it peeked)."""
        self._queue.remove(req)

    def admit(self, n: int) -> List[Any]:
        """Pop up to ``n`` requests in policy order."""
        if n <= 0 or not self._queue:
            return []
        self._sort()
        picked, self._queue = self._queue[:n], self._queue[n:]
        return picked

    # --------------------------------------------------- snapshot / restore

    def snapshot(self) -> dict:
        """The scheduler's own serializable state (DESIGN.md §12).  The
        queued requests themselves are engine objects — the engine
        serializes them (with their ``_arrival`` stamps) and hands them
        back through :meth:`restore`."""
        return {"policy": self.policy, "arrivals": self._arrivals}

    def restore(self, snap: dict, queue: List[Any]) -> None:
        """Adopt a snapshot: the arrival counter continues where it
        stopped (post-restore submissions sort after everything restored)
        and ``queue`` — requests carrying their original ``_arrival``
        stamps — becomes the queue, re-sorted lazily as usual."""
        if snap["policy"] != self.policy:
            raise ValueError(f"snapshot policy {snap['policy']!r} does not "
                             f"match this scheduler ({self.policy!r})")
        self._arrivals = int(snap["arrivals"])
        self._queue = list(queue)
        self._unsorted = True
