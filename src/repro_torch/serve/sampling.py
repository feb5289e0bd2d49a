"""Per-request sampling for the serving engine (counterpart of the
reference's ``serve/sampling.py``, DESIGN.md §6).

Randomness is the stateless hash of ``(seed, vocab_index, counter)``
(``core/rounding.hash_uniform``), bit for bit the reference's, so a request
draws the same Gumbel noise in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, Optional, Tuple

import torch

from repro_torch.core import rounding

__all__ = ["SamplingParams", "sample_tokens"]


@dataclass(frozen=True)
class SamplingParams:
    """Decode-time controls carried by one request.

    * ``temperature <= 0`` — greedy (argmax); otherwise softmax sampling at
      that temperature via Gumbel-max over hash uniforms.
    * ``top_k`` — restrict sampling to the k highest logits (0 = full vocab).
    * ``seed`` — per-request sampling stream seed.
    * ``eos_id`` / ``stop_ids`` — generation stops when the sampled token
      matches (finish_reason "eos" / "stop"; the token is kept in ``out``).
    * ``max_new`` — generated-token budget (finish_reason "length").
    * ``counter_offset`` — per-request dither-counter offset, added to the
      sampling counter and to the int8-KV quantiser counter of the slot.
    """

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    max_new: int = 16
    eos_id: Optional[int] = None
    stop_ids: Tuple[int, ...] = ()
    counter_offset: int = 0

    def stop_set(self) -> FrozenSet[int]:
        stops = set(self.stop_ids)
        if self.eos_id is not None:
            stops.add(self.eos_id)
        return frozenset(stops)


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, seed: torch.Tensor,
                  counter: torch.Tensor) -> torch.Tensor:
    """Sample one token per row under per-row controls.

    logits (B, V) f32; temperature (B,) f32; top_k / seed / counter (B,)
    int32.  Rows with ``temperature <= 0`` take the argmax; the rest draw
    from the top-k-masked, temperature-scaled distribution by Gumbel-max
    over hash uniforms of (seed, vocab index, counter).  Returns (B,) int32.
    """
    v = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)

    k = torch.where(top_k > 0, torch.clamp(top_k, 1, v), v).long()
    sorted_desc = -torch.sort(-logits, dim=-1).values
    thresh = torch.gather(sorted_desc, -1, (k - 1)[:, None])
    masked = torch.where(logits >= thresh, logits, -torch.inf)

    idx = torch.arange(v, dtype=torch.int64, device=logits.device)[None, :]
    u = rounding.hash_uniform(seed[:, None], idx, counter[:, None])
    gumbel = -torch.log(-torch.log(u + 1e-12) + 1e-12)
    scaled = masked / torch.clamp_min(temperature, 1e-6)[:, None]
    sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)
