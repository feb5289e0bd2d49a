"""Plain-torch versions of the port's kernels (counterpart of the
reference's ``kernels/ref.py``).

Each function here computes what its CUDA kernel computes, op for op in the
same recurrence, on any device.  The CPU tests hold these against the JAX
reference, and the card's checks hold every kernel against them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["decode_attention_ref", "paged_decode_attention_ref",
           "verify_attention_ref", "paged_verify_attention_ref",
           "shrink_block"]

_NEG_BIG = -1e30   # the reference's mask value


def shrink_block(bk: int, cap: int) -> int:
    """Largest block size ≤ bk that divides cap (the reference's
    ``kernels/decode_attention.py:shrink_block``: ring slots are positional
    state, so cap is never padded)."""
    bk = max(1, min(bk, cap))
    while cap % bk:
        bk -= 1
    return bk


def _flash_decode(q, tile, nb: int, last, pos, *, hd: int, window: int,
                  quantized: bool) -> torch.Tensor:
    """The split-K online-softmax recurrence both plain versions share.

    ``tile(j)`` returns block j's ``(kb, vb, kp, ksb, vsb)``: K and V
    (B, bk, n_kv, hd), key positions (B, bk) and, when quantised, the
    scales (B, bk, n_kv).  Per block: upcast K to the query dtype, f32 dot,
    ``× 1/sqrt(hd)``, ``× k_scale/127`` when quantised, mask (``kp ≥ 0``,
    ``kp ≤ pos``, optional window) to -1e30, then fold into f32 running
    max, sum and value accumulator, with ``p × v_scale/127`` after the sum
    update.  Rows whose ``last`` block is below j keep their state (the
    length-aware skip).  One body for the ring and the paged cache, so the
    two agree bit for bit on the same tiles.
    """
    bsz, nkv, group = q.shape[0], q.shape[1], q.shape[2]
    dev = q.device
    inv = float(1.0 / math.sqrt(hd))
    qf = q.to(torch.float32)
    m = torch.full((bsz, nkv, group, 1), -math.inf, dtype=torch.float32,
                   device=dev)
    s = torch.zeros((bsz, nkv, group, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bsz, nkv, group, hd), dtype=torch.float32, device=dev)
    pb = pos[:, None, None, None]
    for j in range(nb):
        kb, vb, kpb, ksb, vsb = tile(j)
        kp = kpb[:, None, None, :]
        kc = kb.to(q.dtype).to(torch.float32)
        logits = torch.einsum("bhgd,bkhd->bhgk", qf, kc) * inv
        if quantized:
            logits = logits * (ksb.transpose(1, 2)[:, :, None, :]
                               * (1.0 / 127.0))
        valid = (kp >= 0) & (kp <= pb)
        if window:
            valid = valid & (kp > pb - window)
        logits = torch.where(valid, logits, _NEG_BIG)

        m_new = torch.maximum(m, torch.amax(logits, dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        s_new = s * alpha + torch.sum(p, dim=-1, keepdim=True)
        if quantized:
            p = p * (vsb.transpose(1, 2)[:, :, None, :] * (1.0 / 127.0))
        acc_new = acc * alpha + torch.einsum("bhgk,bkhd->bhgd", p,
                                             vb.to(torch.float32))
        act = (j <= last)[:, None, None, None]
        m = torch.where(act, m_new, m)
        s = torch.where(act, s_new, s)
        acc = torch.where(act, acc_new, acc)
    return acc / s


def decode_attention_ref(
    q: torch.Tensor,        # (B, n_kv, group, hd) bf16/f32 — post-RoPE
    k: torch.Tensor,        # (B, cap, n_kv, hd) int8 codes or bf16
    v: torch.Tensor,        # (B, cap, n_kv, hd)
    k_pos: torch.Tensor,    # (B, cap) int32
    pos: torch.Tensor,      # (B,) int32 per-slot absolute decode position
    k_scale: Optional[torch.Tensor] = None,   # (B, cap, n_kv) f32 when int8
    v_scale: Optional[torch.Tensor] = None,
    *,
    window: int = 0,
    block: Optional[tuple] = None,
) -> torch.Tensor:
    """Flash-decode attention over the ring cache → (B, n_kv, group, hd) f32.

    The split-K online-softmax recurrence of the reference's
    ``decode_attention_ref`` (``_flash_decode``) over cache blocks of
    ``bk`` ring slots, with key positions read from ``k_pos``.  Blocks past
    ``pos // bk`` are skipped (the length-aware skip).  ``block=None`` is
    one whole-cap block.
    """
    bsz, cap, nkv, hd = k.shape
    quantized = k_scale is not None
    bk = shrink_block(cap if block is None else block[0], cap)
    nb = cap // bk
    dev = k.device
    pos = torch.broadcast_to(pos.to(torch.int32), (bsz,))
    last = torch.div(pos, bk, rounding_mode="floor")
    rows = torch.arange(bsz, device=dev)[:, None]
    lane = torch.arange(bk, device=dev)[None, :]

    def gather(x, start):
        """Per-row (bk,)-long block of axis 1, starting at slot ``start``."""
        if nb == 1:
            return x
        return x[rows, start[:, None] + lane]

    def tile(j):
        jc = torch.clamp(last, 0, j) * bk                   # clamped start
        return (gather(k, jc), gather(v, jc), gather(k_pos, jc),
                gather(k_scale, jc) if quantized else None,
                gather(v_scale, jc) if quantized else None)

    return _flash_decode(q, tile, nb, last, pos, hd=hd, window=window,
                         quantized=quantized)


def paged_decode_attention_ref(
    q: torch.Tensor,        # (B, n_kv, group, hd) bf16/f32 — post-RoPE
    k: torch.Tensor,        # (n_blocks, bs, n_kv, hd) int8 codes or bf16
    v: torch.Tensor,        # (n_blocks, bs, n_kv, hd)
    block_tables: torch.Tensor,   # (B, nbmax) int32 physical block ids
    pos: torch.Tensor,      # (B,) int32 per-slot absolute decode position
    k_scale: Optional[torch.Tensor] = None,   # (n_blocks, bs, n_kv) f32
    v_scale: Optional[torch.Tensor] = None,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Flash-decode attention over the paged block pool →
    (B, n_kv, group, hd) f32: the reference's
    ``paged_decode_attention_ref``.

    The same recurrence as ``decode_attention_ref`` (``_flash_decode``)
    with the tile pinned to the pool block ``bs``: logical block j of slot
    b is physical block ``block_tables[b, min(j, pos // bs)]``, and the key
    position of in-block slot t is the implicit ``j·bs + t`` (the pool is
    append-only, so there is no stored k_pos).  For ``bs == bk`` it is bit
    for bit the ring recurrence on the same token stream.
    """
    bs, hd = k.shape[1], k.shape[3]
    bsz = q.shape[0]
    nbmax = block_tables.shape[1]
    quantized = k_scale is not None
    dev = k.device
    pos = torch.broadcast_to(pos.to(torch.int32), (bsz,))
    bt = block_tables.to(torch.int64)
    last = torch.div(pos, bs, rounding_mode="floor")
    rows = torch.arange(bsz, device=dev)
    lane = torch.arange(bs, dtype=torch.int32, device=dev)[None, :]

    def tile(j):
        jc = torch.clamp(last, 0, j)                        # clamped logical
        phys = bt[rows, jc.to(torch.int64)]                 # (B,)
        return (k[phys], v[phys], jc[:, None] * bs + lane,
                k_scale[phys] if quantized else None,
                v_scale[phys] if quantized else None)

    return _flash_decode(q, tile, nbmax, last, pos, hd=hd, window=window,
                         quantized=quantized)


def verify_attention_ref(
    q: torch.Tensor,        # (B, kq, n_kv, group, hd) post-RoPE draft queries
    k: torch.Tensor,        # (B, cap, n_kv, hd) int8 codes or bf16
    v: torch.Tensor,        # (B, cap, n_kv, hd)
    k_pos: torch.Tensor,    # (B, cap) int32
    pos: torch.Tensor,      # (B,) int32 per-slot base (first-row) position
    k_scale: Optional[torch.Tensor] = None,   # (B, cap, n_kv) f32 when int8
    v_scale: Optional[torch.Tensor] = None,
    *,
    window: int = 0,
    block: Optional[tuple] = None,
) -> torch.Tensor:
    """Multi-token verify attention over the ring cache →
    (B, kq, n_kv, group, hd) f32: the reference's ``verify_attention_ref``.

    Literally ``decode_attention_ref`` once per query row: row t is the
    one-token recurrence at position ``pos + t`` over the same cache, and
    the rows stack on axis 1, so row t is bit for bit the plain decode at
    ``pos + t``.  The rows are not fused into one (kq·group, bk) tile: a
    batched product is not row-pure across its rows on every backend, and
    the speculative stream contract needs each row to be exactly the
    sequential decode's.
    """
    pos = pos.to(torch.int32)
    return torch.stack(
        [decode_attention_ref(q[:, t], k, v, k_pos, pos + t, k_scale,
                              v_scale, window=window, block=block)
         for t in range(q.shape[1])], dim=1)


def paged_verify_attention_ref(
    q: torch.Tensor,        # (B, kq, n_kv, group, hd) post-RoPE draft queries
    k: torch.Tensor,        # (n_blocks, bs, n_kv, hd) int8 codes or bf16
    v: torch.Tensor,        # (n_blocks, bs, n_kv, hd)
    block_tables: torch.Tensor,   # (B, nbmax) int32 physical block ids
    pos: torch.Tensor,      # (B,) int32 per-slot base (first-row) position
    k_scale: Optional[torch.Tensor] = None,   # (n_blocks, bs, n_kv) f32
    v_scale: Optional[torch.Tensor] = None,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Multi-token verify attention over the paged block pool →
    (B, kq, n_kv, group, hd) f32: the reference's
    ``paged_verify_attention_ref``, ``paged_decode_attention_ref`` once
    per query row at ``pos + t``, stacked on axis 1 (see
    ``verify_attention_ref`` on why the rows stay separate)."""
    pos = pos.to(torch.int32)
    return torch.stack(
        [paged_decode_attention_ref(q[:, t], k, v, block_tables, pos + t,
                                    k_scale, v_scale, window=window)
         for t in range(q.shape[1])], dim=1)
