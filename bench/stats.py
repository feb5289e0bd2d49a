"""The end-to-end arithmetic over the window's requests, on the host's
clock stamps the engine leaves on each request.

A request's issue time is ``t_submit`` (the client sends it the moment
its last one finished), its first token ``t_first`` and its last
``t_last``.  Each metric is taken over every request of the window, never
a median of chunks:

* ``output_tok_s``: every output token emitted in the window over the
  window's seconds;
* ``ttft_p90_ms``: the 90th percentile of ``t_first - t_submit`` over the
  requests whose first token came in the window;
* ``tpot_p90_ms``: the 90th percentile of ``(t_last - t_first) / (n - 1)``
  over the requests finished in the window.

A request finished in the window counts as attempted, and as failed
unless it stopped for length with exactly its ``max_new`` tokens.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

__all__ = ["percentile", "end_to_end", "Window"]


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The q-th percentile (linear between order statistics), None for no
    values."""
    v = list(values)
    return float(np.percentile(np.asarray(v, np.float64), q)) if v else None


class Window:
    """The measured interval [t0, t1] (engine clock, seconds) and each
    request's output count when it opened and when it closed."""

    def __init__(self, t0: float, t1: float, out_at_open: Dict[int, int],
                 out_at_close: Dict[int, int]):
        self.t0, self.t1 = t0, t1
        self.out_at_open, self.out_at_close = out_at_open, out_at_close

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def inside(self, t: Optional[float]) -> bool:
        return t is not None and self.t0 <= t <= self.t1


def end_to_end(reqs: List, win: Window) -> Dict[str, object]:
    """The window's numbers over ``reqs`` (every request the loop sent,
    each with ``rid``, ``out``, ``max_new``, ``done``, ``finish_reason``
    and the three stamps).  ``emitted`` counts the tokens a request had at
    the window's close, less what it had when it opened; a request only
    counts as finished in the window if it finished by its close."""
    emitted, ttft, tpot = 0, [], []
    finished = []
    for r in reqs:
        emitted += win.out_at_close.get(r.rid, 0) \
            - win.out_at_open.get(r.rid, 0)
        if win.inside(r.t_first):
            ttft.append(r.t_first - r.t_submit)
        if r.done and win.inside(r.t_last):
            finished.append(r)
            if len(r.out) > 1:
                tpot.append((r.t_last - r.t_first) / (len(r.out) - 1))
    failed = [r for r in finished
              if r.finish_reason != "length" or len(r.out) != r.max_new]
    p_ttft, p_tpot = percentile(ttft, 90), percentile(tpot, 90)
    return {
        "output_tok_s": emitted / win.seconds if win.seconds > 0 else None,
        "ttft_p90_ms": None if p_ttft is None else 1e3 * p_ttft,
        "tpot_p90_ms": None if p_tpot is None else 1e3 * p_tpot,
        "n_ttft": len(ttft), "n_tpot": len(tpot), "emitted": emitted,
        "attempted": len(finished), "failed": len(failed),
        "finished": finished,
    }
