"""repro_torch.serve — batched-prefill/decode serving over the ring or the
paged KV cache (DESIGN.md §6)."""

from repro_torch.serve.engine import (Engine, Request, make_decode_and_sample,
                                      make_fused_decode, make_paged_prefill,
                                      make_serve_fns)
from repro_torch.serve.kvpool import KVPool
from repro_torch.serve.sampling import SamplingParams, sample_tokens
from repro_torch.serve.scheduler import Scheduler

__all__ = ["Engine", "Request", "make_serve_fns", "make_decode_and_sample",
           "make_fused_decode", "make_paged_prefill", "KVPool",
           "SamplingParams", "sample_tokens", "Scheduler"]
