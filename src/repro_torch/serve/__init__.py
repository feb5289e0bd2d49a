"""repro_torch.serve — batched-prefill/decode serving over the ring or the
paged KV cache (DESIGN.md §6), with its metrics, tracing and fault
tolerance (DESIGN.md §10, §12, §13)."""

from repro_torch.serve.engine import (Engine, Request, make_chunked_prefill,
                                      make_decode_and_sample,
                                      make_fused_decode, make_paged_prefill,
                                      make_serve_fns)
from repro_torch.serve.kvpool import KVPool
from repro_torch.serve.metrics import (Histogram, JsonlSink, Metrics,
                                       NullSink, StdoutSink, make_sink)
from repro_torch.serve.sampling import SamplingParams, sample_tokens
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.trace import Tracer, format_explain

__all__ = ["Engine", "Request", "make_serve_fns", "make_decode_and_sample",
           "make_fused_decode", "make_chunked_prefill", "make_paged_prefill",
           "KVPool", "SamplingParams", "sample_tokens", "Scheduler",
           "Metrics", "Histogram", "NullSink", "StdoutSink", "JsonlSink",
           "make_sink", "Tracer", "format_explain"]
