"""repro_torch.serve — batched-prefill/decode serving over the ring KV
cache (DESIGN.md §6)."""

from repro_torch.serve.engine import (Engine, Request, make_decode_and_sample,
                                      make_fused_decode, make_serve_fns)
from repro_torch.serve.sampling import SamplingParams, sample_tokens
from repro_torch.serve.scheduler import Scheduler

__all__ = ["Engine", "Request", "make_serve_fns", "make_decode_and_sample",
           "make_fused_decode", "SamplingParams", "sample_tokens",
           "Scheduler"]
