"""The dither policy's products as the timed path makes them, held to the
scheme the configuration states (``bench/reference/dither_product.py``).

After the window (and the traced slice) the loop runs on for a few more
steps of the same traffic, with the policy's product entry wrapped: of
every product the program computes there, a seeded reservoir keeps a few
of the decode ticks (one row a slot at most) and a few of the prefill
waves (a slot's rows at a bucket's length), each with its whole activation, a seeded choice of its
output rows, its seed and counter, and the weight it multiplied.
Once the engine is freed, the reference recomputes those rows from the
activation and the benchmark's own weight, and every output element that
differs is counted.  The activation is the program's state at that
product: the check follows the program one product at a time, and the
token gaps (``check.py``) judge the whole forward.

The wrapper is the program's one hook point for this, the policy's fused
product (``repro_torch.numerics.policy._fused_matmul``), through which
every dense product of a policy cell on one card runs.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.reference import dither_product

__all__ = ["Recorded", "Recorder", "recording", "record", "weight_of",
           "mismatches"]

@dataclass
class Recorded:
    """One product the timed path made."""
    x: torch.Tensor            # (M, K), the whole activation
    w: torch.Tensor            # (K, N), the tensor the program multiplied
    rows: torch.Tensor         # the judged rows of the output
    out: torch.Tensor          # (len(rows), N): the program's output rows
    seed: int
    counter: int


class Recorder:
    """A seeded reservoir of ``per_kind`` products of each kind (decode:
    at most ``slots`` rows; prefill), ``rows`` output rows each."""

    def __init__(self, seed: int, per_kind: int, rows: int, slots: int):
        self.rng = np.random.default_rng([int(seed) % (1 << 64), 11])
        self.slots = int(slots)
        self.per_kind, self.n_rows = int(per_kind), int(rows)
        self.kept: Dict[str, List[Recorded]] = {"decode": [], "prefill": []}
        self.seen = {"decode": 0, "prefill": 0}

    def offer(self, x, w, seed, counter, out):
        kind = "decode" if x.shape[0] <= self.slots else "prefill"
        self.seen[kind] += 1
        kept, i = self.kept[kind], self.seen[kind]
        if len(kept) < self.per_kind:
            slot = len(kept)
        else:
            slot = int(self.rng.integers(i))
            if slot >= self.per_kind:
                return
        m = x.shape[0]
        rows = torch.as_tensor(np.sort(self.rng.choice(
            m, size=min(m, self.n_rows), replace=False)), device=x.device)
        rec = Recorded(x.detach().clone(), w, rows, out[rows].clone(),
                       int(seed), int(counter))
        if slot == len(kept):
            kept.append(rec)
        else:
            kept[slot] = rec

    def records(self) -> List[Recorded]:
        return self.kept["decode"] + self.kept["prefill"]

    def covered(self) -> bool:
        return all(self.seen.values())


@contextmanager
def recording(recorder: Recorder):
    """The policy's fused product wrapped so that ``recorder`` sees every
    call."""
    from repro_torch.numerics import policy as pol

    inner = pol._fused_matmul

    def fused(x, w, policy, seed, counter):
        out = inner(x, w, policy, seed, counter)
        recorder.offer(x, w, seed, counter, out)
        return out

    pol._fused_matmul = fused
    try:
        yield recorder
    finally:
        pol._fused_matmul = inner


def record(loop, seed: int, per_kind: int, rows: int, slots: int,
           max_steps: int = 200) -> List[Recorded]:
    """Step ``loop`` until products of both kinds have been seen (at
    least two steps), keeping a sample of them."""
    rec = Recorder(seed, per_kind, rows, slots)
    with recording(rec):
        for i in range(max_steps):
            loop.step()
            if i >= 1 and rec.covered():
                break
    return rec.records()


def _leaves(params):
    if isinstance(params, dict):
        for v in params.values():
            yield from _leaves(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            yield from _leaves(v)
    elif isinstance(params, torch.Tensor):
        yield params


def weight_of(params, w: torch.Tensor) -> Optional[torch.Tensor]:
    """The benchmark's own weight that the program multiplied as ``w``: a
    2-D matrix of a leaf (a layer's row of a stacked leaf, a head), or
    its transpose, at the same storage, else one equal to it element for
    element; None where the benchmark made no such weight."""
    cands = []
    for leaf in _leaves(params):
        if leaf.dtype != w.dtype or leaf.device != w.device:
            continue
        if leaf.dim() == 3:
            cands += list(leaf.unbind(0))
        elif leaf.dim() == 2:
            cands += [leaf, leaf.T]
    same = [c for c in cands if c.shape == w.shape]
    for c in same:
        if c.data_ptr() == w.data_ptr() and c.stride() == w.stride():
            return c
    return next((c for c in same if torch.equal(c, w)), None)


def mismatches(params, recs: List[Recorded], bits: int) -> Dict[str, float]:
    """Output elements of the recorded products that differ bit for bit
    from the reference's on the ``bits``-bit grid (the configuration's;
    fewer for the control), and the elements judged.  A product whose
    weight the benchmark did not make counts every element it was judged
    on."""
    bad = total = 0
    for r in recs:
        total += r.out.numel()
        wt = weight_of(params, r.w)
        if wt is None:
            bad += r.out.numel()
            continue
        ref = dither_product.product(r.x, wt, bits=bits,
                                     seed=r.seed, counter=r.counter,
                                     rows=r.rows)
        bad += int((ref.view(torch.int16) != r.out.view(torch.int16)).sum()
                   if ref.dtype == torch.bfloat16 else (ref != r.out).sum())
    return {"product_mismatch": float(bad), "product_elements": float(total)}
