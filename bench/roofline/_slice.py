"""What the traced slice asked of the model, from its requests: the
decode steps it ran and the prompt positions it prefilled.

A request of prompt length L that held ``a`` outputs when the slice
opened and ``b`` when it closed got its tokens a … b−1 there.  Token 0
comes from its prefill (positions ``hit`` … L−1, ``hit`` the prefix-hit
tokens it skipped); token j ≥ 1 from the decode step at position
L + j − 1, which reads L + j keys.
"""

from __future__ import annotations

from typing import Iterator, Tuple

__all__ = ["decode_keys", "prefills"]


def decode_keys(run) -> Iterator[int]:
    """The keys each decode step of the slice attends, one per step."""
    for length, _, a, b in run.requests():
        for j in range(max(a, 1), b):
            yield length + j


def prefills(run) -> Iterator[Tuple[int, int]]:
    """(first position prefilled, prompt length) of every request whose
    prefill ran in the slice."""
    for length, hit, a, b in run.requests():
        if a == 0 and b >= 1:
            yield hit, length
