"""The one traffic generator: a closed loop of clients whose requests are
drawn from a mix file (``bench/traffic/<mix>.json``).

A mix gives the engine's settings (``engine``; one client per slot), the
prompt and output length distributions (lognormal by median and sigma,
clipped), and optionally shared system prompts (``shared_prefix``:
count, tokens, Zipf exponent) that each prompt starts with, its own part
then drawn from ``prompt``.

Every seed gets the same work in another order. The lengths and the
system prompt of the j-th request of stream s (j = k·C + s for its k-th
request) lie at the quantiles of low-discrepancy sequences, so any run
of consecutive requests covers the distributions evenly; the seed only
decides which client sends which stream (a rotation), the token ids
(uniform over the vocabulary, drawn per request) and the weights. So the
window's work is the same for every seed, which keeps a window that
finishes a few tens of requests from measuring its own draw. Outputs are
exactly ``max_new`` greedy tokens: no EOS and no stop ids.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

__all__ = ["Spec", "Traffic", "buckets"]

# additive recurrences with irrational steps: prompt, output, prefix choice
_STEPS = (0.6180339887498949, 0.4142135623730951, 0.7320508075688772)


@dataclass(frozen=True)
class Spec:
    """One request as the client sends it."""
    client: int                # -1: a warm-up request
    prompt: tuple
    max_new: int
    prefix: Optional[int]      # which system prompt it starts with


def _quantile(dist: dict, q: float) -> int:
    """The length at quantile q of the lognormal(median, sigma) clipped to
    [min, max]: the clip holds the tails' mass at its ends."""
    z = math.sqrt(2.0) * _erfinv(2.0 * q - 1.0)
    n = round(dist["median"] * math.exp(dist["sigma"] * z))
    return int(min(max(n, dist["min"]), dist["max"]))


def _erfinv(y: float) -> float:
    """Inverse error function by Newton steps from Winitzki's start."""
    y = min(max(y, -1 + 1e-12), 1 - 1e-12)
    a = 0.147
    ln = math.log(1.0 - y * y)
    t = 2.0 / (math.pi * a) + ln / 2.0
    x = math.copysign(math.sqrt(math.sqrt(t * t - ln / a) - t), y)
    for _ in range(3):
        err = math.erf(x) - y
        x -= err / (2.0 / math.sqrt(math.pi) * math.exp(-x * x))
    return x


def buckets(lo: int, hi: int) -> List[int]:
    """The engine's prefill buckets (powers of two, at least 8) that
    lengths in [lo, hi] fall into."""
    out, b = [], 8
    while b < lo:
        b *= 2
    out.append(b)
    while b < hi:
        b *= 2
        out.append(b)
    return out


class Traffic:
    """The request streams of one mix under one seed."""

    def __init__(self, mix: dict, seed: int, vocab_size: int):
        self.mix = mix
        self.seed = int(seed) % (1 << 64)
        self.vocab = int(vocab_size)
        self.clients = int(mix["engine"]["slots"])
        self._rot = int(np.random.default_rng([self.seed, 0]).integers(
            self.clients))
        sp = mix.get("shared_prefix")
        self.prefixes: List[tuple] = []
        self._zipf_cdf: List[float] = []
        if sp:
            self.prefixes = [tuple(self._ids((1 << 32) + i, sp["tokens"]))
                             for i in range(sp["count"])]
            w = [1.0 / (i + 1) ** sp["zipf_s"] for i in range(sp["count"])]
            self._zipf_cdf = list(np.cumsum(w) / sum(w))

    def _ids(self, key: int, n: int) -> List[int]:
        rng = np.random.default_rng([self.seed, 1, key])
        return rng.integers(1, self.vocab, size=n).tolist()

    @staticmethod
    def _q(which: int, j: int) -> float:
        return ((j + 0.5) * _STEPS[which]) % 1.0

    def request(self, client: int, k: int,
                residual: bool = False) -> Spec:
        """Client ``client``'s k-th request.  ``residual`` True: the
        loop's priming request, its output cut to a share of its drawn
        length that its stream sets (so the primed slots finish at
        staggered times)."""
        stream = (client + self._rot) % self.clients
        share = (stream + 0.5) / self.clients
        j = k * self.clients + stream
        own = _quantile(self.mix["prompt"], self._q(0, j))
        max_new = _quantile(self.mix["output"], self._q(1, j))
        if residual:
            max_new = max(1, math.ceil(max_new * share))
        prefix = None
        prompt = self._ids(j, own)
        if self.prefixes:
            u = self._q(2, j)
            prefix = next(i for i, c in enumerate(self._zipf_cdf) if u <= c)
            prompt = list(self.prefixes[prefix]) + prompt
        return Spec(client, tuple(prompt), max_new, prefix)

    def warmup(self) -> List[Spec]:
        """Requests that bring every prefill shape the mix can hit into
        use once before the window: each system prompt first (its blocks
        then sit in the prefix cache), then one prompt for each length
        bucket of the mix's own part, at the bucket's longest length the
        clip allows.  Their outputs span one decode window and one
        more tick."""
        n_out = int(self.mix["engine"]["decode_ticks"]) + 1
        p = self.mix["prompt"]
        out: List[Spec] = []
        for i, pre in enumerate(self.prefixes):
            own = self._ids((2 << 32) + i, p["min"])
            out.append(Spec(-1, pre + tuple(own), n_out, i))
        for b in buckets(p["min"], p["max"]):
            n = min(b, p["max"])
            own = tuple(self._ids((3 << 32) + b, n))
            pre = self.prefixes[0] if self.prefixes else ()
            out.append(Spec(-1, pre + own, n_out,
                            0 if self.prefixes else None))
        return out
