"""What a per-layer metric reads: one run's window and traced slice.

``window`` covers the measured seconds: ``seconds``, ``stats`` (the
engine's counters, zeroed when the window opened) and ``ticks``.
``slice`` covers the traced steps that follow the window (``--trace 1``
only; at least the mix's ``trace_seconds``, and at least one prefill
wave and one decode window): ``seconds``, ``busy_s``, ``steps``,
``ticks``, ``stats`` (the counters''
growth over the slice), ``op_seconds`` (device seconds by operation
name) and ``requests``: for every request the slice touched, (prompt
length, prefix-hit tokens, outputs before, outputs after).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from bench import spec

__all__ = ["Run"]


@dataclass
class Run:
    cell: str
    cfg: dict
    traffic: dict
    peaks: Optional[Dict[str, float]]
    window: Dict = field(default_factory=dict)
    slice: Optional[Dict] = None

    def requests(self) -> List[Tuple[int, int, int, int]]:
        return [] if self.slice is None else self.slice["requests"]

    def kernel_seconds(self, work: str) -> float:
        """Device seconds in the slice of the kernels mapped to ``work``."""
        if self.slice is None:
            return 0.0
        names = spec.kernel_names(work)
        return sum(s for op, s in self.slice["op_seconds"].items()
                   if any(n in op for n in names))

    def work(self, work: str) -> Optional[Dict[str, float]]:
        """``work``'s count over the slice (``bench/roofline/<work>.py``)."""
        return spec.work_counter(work)(self)

    def roofline(self, work: str) -> Optional[float]:
        """The least time of ``work`` over its kernels' device time, in %;
        None where either is missing."""
        counted, spent = self.work(work), self.kernel_seconds(work)
        if not counted or spent <= 0 or self.peaks is None:
            return None
        return 100.0 * counted["seconds"] / spent
