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

__all__ = ["decode_attention_ref", "shrink_block"]

_NEG_BIG = -1e30   # the reference's mask value


def shrink_block(bk: int, cap: int) -> int:
    """Largest block size ≤ bk that divides cap (the reference's
    ``kernels/decode_attention.py:shrink_block``: ring slots are positional
    state, so cap is never padded)."""
    bk = max(1, min(bk, cap))
    while cap % bk:
        bk -= 1
    return bk


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
    ``decode_attention_ref``: per cache block of ``bk`` slots, upcast K to
    the query dtype, f32 dot, ``× 1/sqrt(hd)``, ``× k_scale/127`` when
    quantised, mask (``k_pos ≥ 0``, ``k_pos ≤ pos``, optional window) to
    -1e30, then fold into f32 running max, sum and value accumulator, with
    ``p × v_scale/127`` after the sum update.  Blocks past ``pos // bk`` are
    skipped (the length-aware skip).  ``block=None`` is one whole-cap block.
    """
    bsz, cap, nkv, hd = k.shape
    group = q.shape[2]
    quantized = k_scale is not None
    bk = shrink_block(cap if block is None else block[0], cap)
    nb = cap // bk
    inv = float(1.0 / math.sqrt(hd))
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

    qf = q.to(torch.float32)
    m = torch.full((bsz, nkv, group, 1), -math.inf, dtype=torch.float32,
                   device=dev)
    s = torch.zeros((bsz, nkv, group, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bsz, nkv, group, hd), dtype=torch.float32, device=dev)
    pb = pos[:, None, None, None]
    for j in range(nb):
        jc = torch.clamp(last, 0, j) * bk                   # clamped start
        kb = gather(k, jc)                                  # (B, bk, nkv, hd)
        vb = gather(v, jc)
        kp = gather(k_pos, jc)[:, None, None, :]
        kc = kb.to(q.dtype).to(torch.float32)
        logits = torch.einsum("bhgd,bkhd->bhgk", qf, kc) * inv
        if quantized:
            ksb = gather(k_scale, jc).transpose(1, 2)       # (B, nkv, bk)
            logits = logits * (ksb[:, :, None, :] * (1.0 / 127.0))
        valid = (kp >= 0) & (kp <= pb)
        if window:
            valid = valid & (kp > pb - window)
        logits = torch.where(valid, logits, _NEG_BIG)

        m_new = torch.maximum(m, torch.amax(logits, dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        s_new = s * alpha + torch.sum(p, dim=-1, keepdim=True)
        if quantized:
            vsb = gather(v_scale, jc).transpose(1, 2)
            p = p * (vsb[:, :, None, :] * (1.0 / 127.0))
        acc_new = acc * alpha + torch.einsum("bhgk,bkhd->bhgd", p,
                                             vb.to(torch.float32))
        act = (j <= last)[:, None, None, None]
        m = torch.where(act, m_new, m)
        s = torch.where(act, s_new, s)
        acc = torch.where(act, acc_new, acc)
    return acc / s
