"""Whether the timed path served the right tokens: a sample of the
requests finished in the window, judged against the plain float32
reference (``bench/reference``).

The reference runs once over each sampled prompt followed by its served
tokens (teacher forcing).  At the position before each served token it
gives its own best logit; the token's *gap* is how far the served token's
logit lies below that best (0 where the reference agrees), in logits'
units; valid because every request decodes greedily.

The numbers are the widest gap over every sampled token, and the mean
gap; each cell compares those that separate the program's readings from
its control's (``bench/cells/<cell>.json``'s ``limits``).

The sample is drawn from the seed: the request with the most served
tokens (the longest prompt among those), then others in a seeded order
until it holds ``tokens`` served tokens.  A control (``control``) is the
reference itself computed in a lower precision: the token it puts first
at each position is judged the same way.

A cell under the dither policy also holds the products of its timed path
to the scheme bit for bit (``products.py``): the token gaps cannot tell
the scheme's rounding from another product of like precision, since a
sequence's gaps depend on the batch it was served in.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bench.reference import model as ref

__all__ = ["sample", "gaps", "numbers", "judge"]


def sample(finished: List, tokens: int, seed: int) -> List:
    """The longest of ``finished``, then others in a seeded order, until
    the sample's served tokens reach ``tokens``."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(r.out), len(r.prompt),
                                           -r.rid))
    rest = [r for r in finished if r is not longest]
    order = np.random.default_rng([int(seed) % (1 << 64), 7]).permutation(
        len(rest))
    picked, n = [longest], len(longest.out)
    for i in order:
        if n >= tokens:
            break
        picked.append(rest[i])
        n += len(rest[i].out)
    return picked


def _gaps(params, cfg, prompt, served, control) -> np.ndarray:
    n = len(served)
    seq = list(prompt) + list(served[:-1])
    pos = range(len(prompt) - 1, len(prompt) - 1 + n)
    best = ref.logits_at(params, cfg, seq, pos)
    if control is None:
        tok = torch.as_tensor(served, device=best.device)
    else:
        tok = ref.logits_at(params, cfg, seq, pos, control).argmax(-1)
    picked = best.gather(1, tok.long()[:, None])[:, 0]
    return (best.max(-1).values - picked).cpu().numpy()


def gaps(params, cfg: dict, reqs: List,
         control: Optional[dict] = None) -> np.ndarray:
    """The gap of every served token of ``reqs`` (or, with ``control``,
    of the token the control puts first at each of those positions)."""
    return np.concatenate([_gaps(params, cfg, r.prompt, r.out, control)
                           for r in reqs])


def numbers(g: np.ndarray) -> Dict[str, float]:
    """The numbers a cell may compare: the widest gap, and the mean gap
    over the served tokens (0 where every token is the reference's
    best).  A cell compares those whose readings separate (PERF.md §2)."""
    return {"widest_gap": float(g.max()), "mean_gap": float(g.mean())}


def _held(got: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """Each number of ``limits`` beside its limit (None where the run gave
    no such number, which fails)."""
    return {k: {"value": got.get(k), "limit": float(v)}
            for k, v in limits.items()}


def _ok(checks: Dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())


def judge(params, cfg: dict, finished: List, check: dict, seed: int,
          control: bool = False, recorded: Optional[List] = None,
          bits: Optional[int] = None) -> Dict:
    """The cell's comparisons, each with its number and limit, and
    whether all hold: each number of ``check["limits"]`` over a sample of
    ``finished`` (and, where the check names ``products``, over the
    policy's products ``recorded`` after the window, judged on the
    configuration's ``bits``-bit grid: ``products.py``) within its limit,
    and every sampled request served its ``max_new``.  ``control``: also
    every number of the cell's control (``check["control"]``) on the same
    sample beside the program's, as ``readings``, with the control's
    verdict under the same limits (``control_correct``, which has to come
    out False); the benchmark's own runs print only the compared ones."""
    from bench import products

    reqs = sample(finished, int(check["tokens"]), seed)
    got = {}
    if reqs:
        got = numbers(gaps(params, cfg, reqs))
    if "products" in check:
        got.update(products.mismatches(params, recorded or [], bits))
    checks = _held(got, check["limits"])
    if control:
        ctl = check["control"]
        theirs = numbers(gaps(params, cfg, reqs, ctl)) if reqs else {}
        if "products" in check:
            theirs.update(products.mismatches(params, recorded or [],
                                              int(ctl["bits"])))
        readings = {"program": got, "control": theirs,
                    "control_correct": _ok(_held(theirs, check["limits"]))}
    else:
        readings = {"program": got}
    short = sum(1 for r in reqs if len(r.out) != r.max_new
                or r.finish_reason != "length")
    checks["sampled_short"] = {"value": short, "limit": 0}
    ok = bool(reqs) and _ok(checks)
    return {"correct": ok, "checks": checks, "readings": readings,
            "sampled": {"requests": len(reqs),
                        "tokens": sum(len(r.out) for r in reqs)}}
