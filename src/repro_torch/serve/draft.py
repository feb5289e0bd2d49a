"""Token drafters for speculative decoding (counterpart of the
reference's ``serve/draft.py``, kept as the port's own copy; DESIGN.md
§14).

A :class:`Drafter` proposes up to ``k`` draft tokens per request per decode
window; the engine feeds them through one multi-token verify forward and
commits the longest prefix that matches what sequential sampling would have
produced.  Drafting is pure host-side guesswork — a wrong draft costs only
the rejected verify rows, never correctness, because acceptance is exact
token match against the engine's own sampler (the bitwise stream contract).

:class:`PromptLookupDrafter` is the model-free default: repeated spans are
common in serving workloads (code, templated prose, retrieval contexts), so
the continuation of the latest earlier occurrence of the current suffix
n-gram is a cheap, surprisingly strong draft (assisted-generation prompt
lookup).  The interface stays pluggable for a small zoo draft model later.
"""

from __future__ import annotations

import abc
from typing import List, Sequence

__all__ = ["Drafter", "PromptLookupDrafter", "FixedDrafter", "ReplayDrafter"]


class Drafter(abc.ABC):
    """Proposes draft tokens for one request.

    ``propose`` may return fewer than ``k`` tokens (the engine pads the
    verify window; padding rows are scored but their sampled tokens only
    commit if they happen to match — which is still exact).  It must be
    host-side-cheap: it runs per active slot per decode window.
    """

    @abc.abstractmethod
    def propose(self, context: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` draft tokens continuing ``context`` (prompt + output
        so far)."""


class PromptLookupDrafter(Drafter):
    """Prompt-lookup n-gram drafting: find the latest earlier occurrence of
    the current ``max_ngram``-token suffix in the context and propose the
    tokens that followed it, backing off to shorter n-grams.  O(len·n) scan
    per call — fine at serving context lengths; swap in a suffix automaton
    if contexts grow past ~100k."""

    def __init__(self, max_ngram: int = 3):
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        self.max_ngram = max_ngram

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        ctx = list(context)
        for n in range(min(self.max_ngram, len(ctx) - 1), 0, -1):
            suffix = ctx[-n:]
            # latest earlier occurrence wins: recent repeats predict best
            for start in range(len(ctx) - n - 1, -1, -1):
                if ctx[start:start + n] == suffix:
                    cont = ctx[start + n:start + n + k]
                    if cont:
                        return cont
        return []


class ReplayDrafter(Drafter):
    """Replays known per-request streams, keyed by prompt prefix: a request
    whose context starts with a registered prompt — and whose output so far
    has followed that prompt's recorded stream — is proposed the next ``k``
    recorded tokens.  An oracle drafter: against deterministic sampling its
    accept rate is 1 by construction, which makes it the harness for the
    bulk-commit speedup *ceiling* (record one plain wave, then replay it
    through the spec engine) and the accept-all edge in parity tests."""

    def __init__(self, streams):
        # streams: {prompt token tuple -> recorded output token list}
        self.streams = {tuple(p): list(out) for p, out in streams.items()}

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        ctx = list(context)
        for prompt, out in self.streams.items():
            n = len(prompt)
            if (len(ctx) >= n and tuple(ctx[:n]) == prompt
                    and ctx[n:] == out[:len(ctx) - n]):
                done = len(ctx) - n
                return out[done:done + k]
        return []


class FixedDrafter(Drafter):
    """Always proposes the same token sequence (cycled to length ``k``) —
    the accept-all / reject-all edge-case harness for parity tests, and a
    stand-in for workloads with a known continuation."""

    def __init__(self, tokens: Sequence[int]):
        if not tokens:
            raise ValueError("FixedDrafter needs at least one token")
        self.tokens = list(tokens)

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        reps = -(-k // len(self.tokens))
        return (self.tokens * reps)[:k]
