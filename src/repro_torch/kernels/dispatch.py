"""Kernel dispatch of the port (counterpart of the reference's
``kernels/dispatch.py``): two backends per kernel.

* ``cuda`` — the hand-written kernel; raises on CPU tensors.
* ``torch-ref`` — the plain-torch recurrence of ``kernels/ref.py``, on any
  device.

``backend=None`` picks ``cuda`` for CUDA tensors and ``torch-ref`` for CPU
tensors.  ``torch-ref`` on CUDA tensors runs only when a caller names it, as
the card's checks do; nothing on the serving path does.  No environment
variable takes part.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import ref

__all__ = ["BACKENDS", "resolve_backend", "decode_attention"]

BACKENDS = ("cuda", "torch-ref")


def resolve_backend(backend: Optional[str], t: torch.Tensor) -> str:
    """The concrete backend for an operand ``t``; raises on an unknown name
    and on ``cuda`` for a tensor that is not on a CUDA device."""
    name = backend if backend is not None else (
        "cuda" if t.is_cuda else "torch-ref")
    if name not in BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; available: "
                         f"{BACKENDS}")
    if name == "cuda" and not t.is_cuda:
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got {t.device}")
    return name


def decode_attention(
    q: torch.Tensor,        # (B, n_kv_heads, group, hd) — post-RoPE queries
    k: torch.Tensor,        # (B, cap, n_kv_heads, hd) int8 codes or bf16
    v: torch.Tensor,        # (B, cap, n_kv_heads, hd)
    k_pos: torch.Tensor,    # (B, cap) int32 absolute position per ring slot
    pos: torch.Tensor,      # (B,) int32 per-slot decode position
    *,
    k_scale: Optional[torch.Tensor] = None,   # (B, cap, n_kv) f32 when int8
    v_scale: Optional[torch.Tensor] = None,
    window: int = 0,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Flash-decode attention over the ring KV cache → (B, n_kv, group, hd)
    f32, through the selected backend.  ``torch-ref`` runs the recurrence as
    one whole-cap block, the reference's ``xla-ref`` default."""
    if resolve_backend(backend, q) == "cuda":
        return _da.decode_attention(q, k, v, k_pos, pos, k_scale, v_scale,
                                    window=window)
    return ref.decode_attention_ref(q, k, v, k_pos, pos, k_scale, v_scale,
                                    window=window)
