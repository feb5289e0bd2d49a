"""The closed loop: one client per engine slot, each sending its next
request the moment its last one finishes (the regime of offline batches
and agent loops).  No queue builds, so a request's time to first token is
its admission and its prefill wave.

The loop is a function of engine steps, never of the clock: which request
is sent when, and so every step's work, follows from the seed.  Only how
long the steps take is measured.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

from bench.traffic import Spec, Traffic

__all__ = ["ClosedLoop"]


class ClosedLoop:
    """Drives ``engine`` (``submit`` / ``step`` / ``finished``) with the
    requests of ``traffic``; ``make_request(rid, prompt, max_new)`` builds
    the program's request.  ``span(name)`` wraps the loop's host work
    (``torch.profiler.record_function`` in a traced run)."""

    def __init__(self, engine, traffic: Traffic,
                 make_request: Callable, span: Callable = None):
        self.engine, self.traffic = engine, traffic
        self._make = make_request
        self._span = span or (lambda name: contextlib.nullcontext())
        self.specs: Dict[int, Spec] = {}
        self.requests: List = []
        self._next = [0] * traffic.clients
        self._seen = 0
        self.open = True

    def submit(self, spec: Spec):
        req = self._make(len(self.requests), spec.prompt, spec.max_new)
        self.specs[req.rid] = spec
        self.requests.append(req)
        self.engine.submit(req)
        return req

    def prime(self):
        """Every client sends its first request, its output cut to a
        staggered share so that the slots finish one after another."""
        for c in range(self.traffic.clients):
            self.submit(self.traffic.request(c, 0, residual=True))
            self._next[c] = 1

    def step(self):
        """One engine step, then each client whose request finished sends
        its next."""
        with self._span("bench.engine_step"):
            self.engine.step()
        done = self.engine.finished[self._seen:]
        self._seen = len(self.engine.finished)
        if not self.open:
            return
        with self._span("bench.submit"):
            for req in done:
                c = self.specs[req.rid].client
                if c < 0:
                    continue
                self.submit(self.traffic.request(c, self._next[c]))
                self._next[c] += 1

    def serve_alone(self, spec: Spec, max_steps: int = 10_000):
        """Send one request and step until it finishes (warm-up)."""
        req = self.submit(spec)
        for _ in range(max_steps):
            if req.done:
                return req
            self.step()
        raise RuntimeError(f"warm-up request {req.rid} did not finish in "
                           f"{max_steps} steps")

    def out_counts(self) -> Dict[int, int]:
        return {r.rid: len(r.out) for r in self.requests}
