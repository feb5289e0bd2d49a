"""Kernel dispatch of the port (counterpart of the reference's
``kernels/dispatch.py``): two backends per kernel.

* ``cuda`` — the hand-written kernel; raises on CPU tensors.
* ``torch-ref`` — the plain-torch version in ``kernels/ref.py``, on any
  device.

``backend=None`` (or ``"auto"``) picks ``cuda`` for CUDA tensors and
``torch-ref`` for CPU tensors.  ``torch-ref`` on CUDA tensors runs only when
a caller names it, as the card's checks do; nothing on the serving path
does.  No environment variable chooses the backend.

Every entry takes the reference's ``block``, its kernel's launch
parameters (``kernels/autotune.py``).  On ``cuda``, ``block=None`` asks the
autotuner (``autotune.resolve``: the winner of a sweep cached for the key,
else the model pick, which is the launch the kernels took before it); a
given block sets the launch.  A block that is not a candidate at the
call's shape raises ``ValueError`` before any launch, on either backend.
On ``torch-ref`` a given ring tile ``(bk,)`` runs the plain recurrence at
that tile and ``None`` keeps the reference's whole-cap default; the
dither kernels' plain versions give the same bits at any block.  The
paged entries' block is the pool's, ``(k.shape[1],)``: ``None`` or that.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import dither_matmul as _dm
from repro_torch.kernels import paged_decode_attention as _pda
from repro_torch.kernels import paged_verify_attention as _pva
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import ref
from repro_torch.kernels import verify_attention as _va

__all__ = ["BACKENDS", "UNFUSED", "available_backends", "resolve_backend",
           "resolve_policy_backend", "matmul", "quantize", "decode_attention",
           "paged_decode_attention", "verify_attention",
           "paged_verify_attention"]

BACKENDS = ("cuda", "torch-ref")
# QuantPolicy.backend of the unfused fake-quant matmul (the reference's "jnp")
UNFUSED = "torch"


def available_backends() -> tuple:
    """The kernel backends' names, sorted (the reference's
    ``available_backends``; the port's are fixed, ``BACKENDS``)."""
    return tuple(sorted(BACKENDS))


def resolve_backend(backend: Optional[str], t: torch.Tensor) -> str:
    """The concrete backend for an operand ``t``; raises on an unknown name
    and on ``cuda`` for a tensor that is not on a CUDA device."""
    name = backend if backend not in (None, "auto") else (
        "cuda" if t.is_cuda else "torch-ref")
    if name not in BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; available: "
                         f"{BACKENDS}")
    if name == "cuda" and not t.is_cuda:
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got {t.device}")
    return name


def resolve_policy_backend(name: str, device=None) -> str:
    """``QuantPolicy.backend`` resolution: the unfused path's name
    (``UNFUSED``) passes through; ``"auto"`` becomes ``cuda`` on a CUDA
    ``device`` and ``torch-ref`` on the CPU (with no device it stays
    ``"auto"``, which each call resolves by its operands' device); a
    concrete backend name is checked and kept."""
    if name == UNFUSED:
        return name
    if name in (None, "auto"):
        if device is None:
            return "auto"
        return "cuda" if torch.device(device).type == "cuda" else "torch-ref"
    if name not in BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; available: "
                         f"{(UNFUSED, 'auto') + BACKENDS}")
    return name


def _pool_block(k: torch.Tensor, block: Optional[tuple]) -> None:
    """A paged entry's ``block`` is the pool's block, ``(k.shape[1],)``:
    that pool was laid out with it (its default from
    ``autotune.best_block("paged_attention", ...)``); any other raises."""
    if block is not None and tuple(block) != (k.shape[1],):
        raise ValueError(f"paged block {tuple(block)} is not the pool's "
                         f"({k.shape[1]},): the tile is the pool block")


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bits: int,
    scheme: str = "dither",
    counter=0,
    seed: int = 0,
    a_range: tuple = (0.0, 1.0),
    b_range: tuple = (0.0, 1.0),
    fmt: str = "spread",
    block: Optional[tuple] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Quantised A @ B (§VIII 'separate') → (M, N) f32 through the selected
    backend; the operands are taken in f32.  ``block``: kernel 6's
    launch parameters at (M, K, N)."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    kw = dict(bits=bits, scheme=scheme, a_range=a_range, b_range=b_range,
              counter=counter, seed=seed, fmt=fmt)
    if resolve_backend(backend, a) == "cuda":
        return _dm.dither_matmul(a.contiguous(), b.contiguous(), block=block,
                                 **kw)
    if block is not None:
        autotune.check_block("matmul", (a.shape[0],) + tuple(b.shape),
                             a.dtype, block)
    return ref.dither_matmul_ref(a, b, **kw)


def quantize(
    x: torch.Tensor,
    *,
    bits: int,
    lo: float = 0.0,
    hi: float = 1.0,
    scheme: str = "dither",
    counter=0,
    seed: int = 0,
    n_pulses: int = 16,
    fmt: str = "spread",
    block: Optional[tuple] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """k-bit int32 codes of a 2-D ``x`` over [lo, hi] through the selected
    backend; ``x`` is taken in f32.  ``block``: kernel 5's launch takes no
    parameter, so only its one candidate ``()`` (or None)."""
    x = x.to(torch.float32)
    if block is not None:
        autotune.check_block("quantize", tuple(x.shape), x.dtype, block)
    kw = dict(scale=((1 << bits) - 1) / (hi - lo), zero=lo, bits=bits,
              scheme=scheme, counter=counter, seed=seed, n_pulses=n_pulses,
              fmt=fmt)
    if resolve_backend(backend, x) == "cuda":
        return _q.quantize(x.contiguous(), **kw)
    return ref.quantize_codes_ref(x, **kw)


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
    block: Optional[tuple] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Flash-decode attention over the ring KV cache → (B, n_kv, group, hd)
    f32, through the selected backend, at tile ``block=(bk,)``.  With
    ``block`` None ``torch-ref`` runs the recurrence as one whole-cap
    block, the reference's ``xla-ref`` default."""
    if resolve_backend(backend, q) == "cuda":
        return _da.decode_attention(q, k, v, k_pos, pos, k_scale, v_scale,
                                    window=window, block=block)
    if block is not None:
        block = (_da.ring_tile("decode_attention", q, k, block),)
    return ref.decode_attention_ref(q, k, v, k_pos, pos, k_scale, v_scale,
                                    window=window, block=block)


def paged_decode_attention(
    q: torch.Tensor,        # (B, n_kv_heads, group, hd) — post-RoPE queries
    k: torch.Tensor,        # (n_blocks, bs, n_kv_heads, hd) int8 codes or bf16
    v: torch.Tensor,        # (n_blocks, bs, n_kv_heads, hd)
    block_tables: torch.Tensor,   # (B, nbmax) int32 physical block per logical
    pos: torch.Tensor,      # (B,) int32 per-slot decode position
    *,
    k_scale: Optional[torch.Tensor] = None,   # (n_blocks, bs, n_kv) f32
    v_scale: Optional[torch.Tensor] = None,
    window: int = 0,
    block: Optional[tuple] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Flash-decode attention over the paged block pool →
    (B, n_kv, group, hd) f32, through the selected backend.  The tile is
    the pool block on both backends (``block``: None or the pool's), so
    ``torch-ref`` runs the kernel's own recurrence (the reference's
    ``xla-ref`` does the same)."""
    _pool_block(k, block)
    if resolve_backend(backend, q) == "cuda":
        return _pda.paged_decode_attention(q, k, v, block_tables, pos,
                                           k_scale, v_scale, window=window)
    return ref.paged_decode_attention_ref(q, k, v, block_tables, pos,
                                          k_scale, v_scale, window=window)


def verify_attention(
    q: torch.Tensor,        # (B, kq, n_kv_heads, group, hd) — post-RoPE
    k: torch.Tensor,        # (B, cap, n_kv_heads, hd) int8 codes or bf16
    v: torch.Tensor,        # (B, cap, n_kv_heads, hd)
    k_pos: torch.Tensor,    # (B, cap) int32 absolute position per ring slot
    pos: torch.Tensor,      # (B,) int32 per-slot first-row position
    *,
    k_scale: Optional[torch.Tensor] = None,   # (B, cap, n_kv) f32 when int8
    v_scale: Optional[torch.Tensor] = None,
    window: int = 0,
    block: Optional[tuple] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Speculative verify attention over the ring KV cache →
    (B, kq, n_kv, group, hd) f32: row t attends as a decode at ``pos + t``
    at the same tile ``block=(bk,)`` (the autotuner's verify pick is its
    decode pick).  With ``block`` None ``torch-ref`` runs
    ``decode_attention``'s whole-cap recurrence once per row (the
    reference's ``xla-ref`` default)."""
    if resolve_backend(backend, q) == "cuda":
        return _va.verify_attention(q, k, v, k_pos, pos, k_scale, v_scale,
                                    window=window, block=block)
    if block is not None:
        block = (_da.ring_tile("verify_attention", q, k, block),)
    return ref.verify_attention_ref(q, k, v, k_pos, pos, k_scale, v_scale,
                                    window=window, block=block)


def paged_verify_attention(
    q: torch.Tensor,        # (B, kq, n_kv_heads, group, hd) — post-RoPE
    k: torch.Tensor,        # (n_blocks, bs, n_kv_heads, hd) int8 codes or bf16
    v: torch.Tensor,        # (n_blocks, bs, n_kv_heads, hd)
    block_tables: torch.Tensor,   # (B, nbmax) int32 physical block per logical
    pos: torch.Tensor,      # (B,) int32 per-slot first-row position
    *,
    k_scale: Optional[torch.Tensor] = None,   # (n_blocks, bs, n_kv) f32
    v_scale: Optional[torch.Tensor] = None,
    window: int = 0,
    block: Optional[tuple] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Speculative verify attention over the paged block pool →
    (B, kq, n_kv, group, hd) f32: row t attends as a paged decode at
    ``pos + t``, the tile pinned to the pool block on both backends
    (``block``: None or the pool's)."""
    _pool_block(k, block)
    if resolve_backend(backend, q) == "cuda":
        return _pva.paged_verify_attention(q, k, v, block_tables, pos,
                                           k_scale, v_scale, window=window)
    return ref.paged_verify_attention_ref(q, k, v, block_tables, pos,
                                          k_scale, v_scale, window=window)
