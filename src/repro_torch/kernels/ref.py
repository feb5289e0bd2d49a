"""Plain-torch versions of the port's kernels (counterpart of the
reference's ``kernels/ref.py``).

Each function here computes what its CUDA kernel computes, op for op in the
same recurrence, on any device.  The CPU tests hold these against the JAX
reference, and the card's checks hold every kernel against them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import rounding

__all__ = ["quantize_codes_ref", "dither_round_ref", "stochastic_round_ref",
           "dither_matmul_ref", "dither_matmul_scaled_ref", "policy_absmax",
           "dequant_constants", "fma_f32", "MatmulBlock",
           "dither_matmul_epilogue_ref", "dither_matmul_scaled_epilogue_ref",
           "decode_attention_ref",
           "paged_decode_attention_ref", "verify_attention_ref",
           "paged_verify_attention_ref", "shrink_block"]

_NEG_BIG = -1e30   # the reference's mask value


def _f32(v: float) -> float:
    """A Python float rounded to f32 (kept as a Python float, exactly)."""
    return float(np.float32(v))


def quantize_codes_ref(
    x: torch.Tensor,
    *,
    scale: float,
    zero: float,
    bits: int,
    scheme: str,
    counter,
    seed: int,
    n_pulses: int,
    fmt: str = "spread",
    index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """k-bit integer codes of a 2-D tensor (the reference's
    ``quantize_codes_ref``): ``clip(round_scheme((x - zero) * scale), 0,
    2^bits - 1)`` as int32, where the hash's element index is the
    unpadded global row-major index (``index``, uint32 in int64, where x
    is one block of a larger operand).  Every step is the reference's f32
    op in its order, so the codes are bitwise the reference's."""
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    levels = (1 << bits) - 1
    scaled = (x.to(torch.float32) - _f32(zero)) * _f32(scale)
    idx = rounding._flat_index(scaled) if index is None else index
    if scheme == "deterministic":
        codes = rounding.deterministic_round(scaled)
    elif scheme == "stochastic":
        u = rounding.hash_uniform(seed, idx, counter)
        fl = torch.floor(scaled)
        codes = fl + (u < scaled - fl).to(torch.float32)
    elif scheme == "dither":
        fl = torch.floor(scaled)
        slot = rounding.slot_index(counter, idx, n_pulses, seed=seed, fmt=fmt)
        u = rounding.hash_uniform(rounding._u32(seed) ^ 0xD1CE, idx, counter)
        codes = fl + rounding.dither_bit(scaled - fl, slot, u, n_pulses)
    else:
        raise ValueError(f"unknown rounding scheme {scheme!r}")
    return torch.clamp(codes, 0.0, float(levels)).to(torch.int32)


def dither_round_ref(x, *, scale, zero, bits, counter, seed, n_pulses):
    return quantize_codes_ref(
        x, scale=scale, zero=zero, bits=bits, scheme="dither",
        counter=counter, seed=seed, n_pulses=n_pulses)


def stochastic_round_ref(x, *, scale, zero, bits, counter, seed):
    return quantize_codes_ref(
        x, scale=scale, zero=zero, bits=bits, scheme="stochastic",
        counter=counter, seed=seed, n_pulses=2)


def dequant_constants(bits: int, a_range, b_range, k: int):
    """The f32 constants of the dither matmul's dequantisation, as the
    reference computes it: ``(sa, sb, r_acc, c_col, c_row, c_k)``.

    The reference writes ``cc / (sa·sb) + a0·colsum / sb + b0·rowsum / sa
    + K·a0·b0``.  Compiled (its ``xla-ref`` backend, and its Pallas body in
    interpret mode), each division by a constant becomes a multiplication
    by the f32 reciprocal with the zero folded in, and the first sum is
    contracted into a fused multiply-add, so what runs is
    ``fma(cc, r_acc, colsum·c_col) + rowsum·c_row + c_k``, left to right,
    every other op rounded to f32, with ``r_acc = 1/f32(sa·sb)``,
    ``c_col = f32(a0)·(1/f32(sb))``, ``c_row = f32(b0)·(1/f32(sa))`` and
    ``c_k = f32(K·a0·b0)`` (pinned bitwise in
    ``tests/test_torch_dither_kernels.py``).  With both zeros 0 the
    reference skips the cross terms: ``cc·r_acc``.
    """
    levels = float((1 << bits) - 1)
    sa = levels / (a_range[1] - a_range[0])
    sb = levels / (b_range[1] - b_range[0])
    one = np.float32(1.0)
    r_acc = one / np.float32(sa * sb)
    c_col = np.float32(a_range[0]) * (one / np.float32(sb))
    c_row = np.float32(b_range[0]) * (one / np.float32(sa))
    c_k = np.float32(k * a_range[0] * b_range[0])
    return sa, sb, float(r_acc), float(c_col), float(c_row), float(c_k)


@dataclass(frozen=True)
class MatmulBlock:
    """One block of an (M, K) @ (K, N) product whose operands are split
    over a mesh: the global ``M``, ``K``, ``N``, and where the block sits.
    Its local row m is global row ``m0 + (m // seg) * seg_stride + m %
    seg`` (``seg`` 0: one segment, ``m0 + m``; a token shard of the
    sequence split is ``seg`` = its S/tp rows, ``seg_stride`` = S); its K
    slice starts at ``k0`` and its columns at ``n0``.  Hash indices and
    pulse counts are the global operands' (kernel 6's sharded entry)."""
    M: int
    K: int
    N: int
    m0: int = 0
    seg: int = 0
    seg_stride: int = 0
    k0: int = 0
    n0: int = 0

    def global_rows(self, m: int, device, r0: int = 0) -> torch.Tensor:
        """The global rows of local rows ``r0 .. r0 + m``."""
        r = torch.arange(r0, r0 + m, dtype=torch.int64, device=device)
        if self.seg:
            r = (r // self.seg) * self.seg_stride + r % self.seg
        return r + self.m0

    def a_index(self, m: int, k: int, device, r0: int = 0) -> torch.Tensor:
        """A's global row-major indices (uint32 in int64) of the block's
        local rows ``r0 .. r0 + m`` and its K slice of width k."""
        cols = torch.arange(k, dtype=torch.int64, device=device) + self.k0
        return (self.global_rows(m, device, r0)[:, None] * self.K
                + cols[None, :]) & 0xFFFFFFFF

    def b_index(self, k: int, n: int, device, r0: int = 0) -> torch.Tensor:
        """B's global row-major indices of the block's local rows ``r0 ..
        r0 + k`` (its K slice) and its n columns."""
        rows = torch.arange(r0, r0 + k, dtype=torch.int64,
                            device=device) + self.k0
        cols = torch.arange(n, dtype=torch.int64, device=device) + self.n0
        return (rows[:, None] * self.N + cols[None, :]) & 0xFFFFFFFF


# elements of an operand or output the plain versions work on at once: the
# hash's int64 temporaries of a whole LM head would take gigabytes; every
# step is elementwise or a row's own, so chunking rows changes no bit
_CHUNK = 1 << 22


def _row_chunks(rows: int, cols: int, device=None):
    """Row blocks of at most ``_CHUNK`` elements; one block on the meta
    device, where nothing is stored (the dry run, ``launch/dryrun.py``)."""
    if device is not None and torch.device(device).type == "meta":
        return [(0, rows)]
    step = max(1, _CHUNK // max(1, cols))
    return [(i, min(rows, i + step)) for i in range(0, rows, step)]


def dither_matmul_ref(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bits: int,
    scheme: str = "dither",
    a_range=(0.0, 1.0),
    b_range=(0.0, 1.0),
    counter=0,
    seed: int = 0,
    fmt: str = "spread",
    block: Optional[MatmulBlock] = None,
    partials: bool = False,
):
    """Quantise-and-multiply, §VIII 'separate' (the reference's
    ``dither_matmul_ref``): A quantised with ``seed`` and N_A =
    max(N, 2) pulses, B with ``seed + 1`` and N_B = max(M, 2), multiplied
    on the integer grid and mapped back → (M, N) f32.

    The integer product is exact (codes in float64, whose sums of
    integers below 2^53 are exact in any order) and rounded once to f32;
    the reference's f32 HIGHEST dot is the same wherever K·(2^bits−1)²
    < 2^24.  Then the reference's dequantisation (``dequant_constants``).

    ``block``: a and b are one block of a larger product
    (``MatmulBlock``): hash indices, pulse counts and the dequantisation's
    K are the global product's, so a row or column block is the slice of
    the unsharded product bit for bit.  ``partials``: return the block's
    int32 ``(acc (M, N), rowsum (M,), colsum (N,))`` instead, whose sums
    over the K blocks ``dither_matmul_epilogue_ref`` maps to the unsharded
    product bit for bit.
    """
    (p, q), (q2, r) = a.shape, b.shape
    if q != q2:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    g = block if block is not None else MatmulBlock(p, q, r)
    sa, sb = dequant_constants(bits, a_range, b_range, g.K)[:2]
    q_kw = dict(bits=bits, scheme=scheme, counter=counter, fmt=fmt)
    ca = torch.cat([quantize_codes_ref(
        a[i:j], scale=sa, zero=a_range[0], seed=seed, n_pulses=max(g.N, 2),
        index=g.a_index(j - i, q, a.device, i), **q_kw)
        for i, j in _row_chunks(p, q, a.device)])
    cb = torch.cat([quantize_codes_ref(
        b[i:j], scale=sb, zero=b_range[0], seed=seed + 1,
        n_pulses=max(g.M, 2), index=g.b_index(j - i, r, b.device, i),
        **q_kw) for i, j in _row_chunks(q, r, b.device)])
    colsum = cb.sum(dim=0, dtype=torch.int64)
    rowsum = ca.sum(dim=1, dtype=torch.int64)
    cbd = cb.double()
    parts = []
    for i, j in _row_chunks(p, r, a.device):
        acc = (ca[i:j].double() @ cbd).to(torch.int64)
        parts.append(acc.to(torch.int32) if partials else
                     dither_matmul_epilogue_ref(
                         acc, rowsum[i:j], colsum, bits=bits,
                         a_range=a_range, b_range=b_range, k=g.K))
    out = torch.cat(parts)
    if partials:
        return out, rowsum.to(torch.int32), colsum.to(torch.int32)
    return out


def dither_matmul_epilogue_ref(acc, rowsum, colsum, *, bits: int,
                               a_range=(0.0, 1.0), b_range=(0.0, 1.0),
                               k: int) -> torch.Tensor:
    """The dequantisation of an integer product → (M, N) f32: ``acc``
    (M, N), ``rowsum`` (M,) and ``colsum`` (N,) summed over the whole K
    (``k``), then the reference's compiled epilogue
    (``dequant_constants``)."""
    _, _, r_acc, c_col, c_row, c_k = dequant_constants(bits, a_range,
                                                      b_range, k)
    acc = acc.to(torch.float32)
    if a_range[0] == 0.0 and b_range[0] == 0.0:
        return acc * r_acc
    colsum, rowsum = colsum.to(torch.float32), rowsum.to(torch.float32)
    out = fma_f32(acc, r_acc, (colsum * c_col)[None, :])
    out = out + (rowsum * c_row)[:, None]
    return out + c_k


def policy_absmax(t: torch.Tensor) -> torch.Tensor:
    """The quantised-matmul policy's operand range: ``clamp_min(max |t|,
    1e-6)`` as a 0-dim tensor in t's dtype."""
    return torch.clamp_min(torch.amax(torch.abs(t)), 1e-6)


def dither_matmul_scaled_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    w_absmax: Optional[torch.Tensor] = None,
    *,
    bits: int,
    scheme: str = "dither",
    counter=0,
    seed: int = 0,
    fmt: str = "spread",
    x_absmax: Optional[torch.Tensor] = None,
    block: Optional[MatmulBlock] = None,
    partials: bool = False,
):
    """The quantised-matmul policy's product (``numerics/policy.py``
    ``_fused_matmul``), the plain version of ``dither_matmul_scaled``: both
    operands normalised by their absmax (``policy_absmax``; the weight's
    may be given) in their own dtype, taken in f32 through
    ``dither_matmul_ref`` over the range (-1, 1), and the product scaled
    back by ``ax * aw`` and cast to x's dtype.

    The plain version of kernel 6's sharded entry
    (``dither_matmul_sharded``) too: ``x_absmax`` given (the global
    operand's), ``block`` and ``partials`` as ``dither_matmul_ref``'s;
    partials are scaled by ``dither_matmul_scaled_epilogue_ref``."""
    ax = policy_absmax(x) if x_absmax is None else x_absmax
    aw = policy_absmax(w) if w_absmax is None else w_absmax
    out = dither_matmul_ref(
        (x / ax).to(torch.float32), (w / aw).to(torch.float32), bits=bits,
        scheme=scheme, a_range=(-1.0, 1.0), b_range=(-1.0, 1.0),
        counter=counter, seed=seed, fmt=fmt, block=block, partials=partials)
    if partials:
        return out
    return (out * (ax * aw)).to(x.dtype)


def dither_matmul_scaled_epilogue_ref(acc, rowsum, colsum, x_absmax,
                                      w_absmax, *, bits: int, k: int,
                                      dtype=torch.bfloat16) -> torch.Tensor:
    """The policy product from all-reduced partials of
    ``dither_matmul_scaled_ref(..., partials=True)``: the epilogue over
    (-1, 1) at the global ``k``, scaled by ``x_absmax * w_absmax`` and cast
    to ``dtype``, the plain version of ``dither_matmul_epilogue``."""
    scale = x_absmax * w_absmax
    return torch.cat([(dither_matmul_epilogue_ref(
        acc[i:j], rowsum[i:j], colsum, bits=bits, a_range=(-1.0, 1.0),
        b_range=(-1.0, 1.0), k=k) * scale).to(dtype)
        for i, j in _row_chunks(acc.shape[0], acc.shape[1], acc.device)])


def fma_f32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a·b + c`` rounded once (a fused multiply-add), emulated exactly
    in float64 on any device: ``a·b`` of two f32 values is exact in f64,
    TwoSum gives the f64 sum's rounding error, and rounding the sum to odd
    before the cast to f32 avoids a double rounding."""
    p = a.double() * b
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def shrink_block(bk: int, cap: int) -> int:
    """Largest block size ≤ bk that divides cap (the reference's
    ``kernels/decode_attention.py:shrink_block``: ring slots are positional
    state, so cap is never padded)."""
    bk = max(1, min(bk, cap))
    while cap % bk:
        bk -= 1
    return bk


def _flash_decode(q, tile, nb: int, last, pos, *, hd: int, window: int,
                  quantized: bool, split: Optional[int] = None
                  ) -> torch.Tensor:
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

    ``split`` is the CUDA kernels' split order (``None``: one recurrence
    over all blocks).  With ``split=S``, blocks ``[s·S, (s+1)·S)`` are
    recurrence s of their own; a row with at most S blocks to read (up to
    ``min(last, nb - 1)``) returns its first recurrence's ``acc / s``, bit
    for bit the unsplit result, and a longer row merges its recurrences in
    ascending s: ``M = max m_s``, ``w_s = exp(m_s − M)``, ``Σ w_s·acc_s /
    Σ w_s·s_s``, each product and sum rounded to f32.
    """
    bsz, nkv, group = q.shape[0], q.shape[1], q.shape[2]
    dev = q.device
    inv = float(1.0 / math.sqrt(hd))
    qf = q.to(torch.float32)
    pb = pos[:, None, None, None]
    span = nb if split is None else split

    def recurrence(j0, j1):
        m = torch.full((bsz, nkv, group, 1), -math.inf, dtype=torch.float32,
                       device=dev)
        s = torch.zeros((bsz, nkv, group, 1), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((bsz, nkv, group, hd), dtype=torch.float32,
                          device=dev)
        for j in range(j0, j1):
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

            m_new = torch.maximum(m, torch.amax(logits, dim=-1,
                                                keepdim=True))
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
        return m, s, acc

    parts = [recurrence(j0, min(j0 + span, nb)) for j0 in range(0, nb, span)]
    m0, s0, acc0 = parts[0]
    if len(parts) == 1:
        return acc0 / s0
    # a row's recurrences: those that hold one of its blocks
    nsplit = (torch.clamp(last, max=nb - 1) // span + 1)[:, None, None, None]
    mx = parts[0][0]
    for i, (m, _, _) in enumerate(parts[1:], 1):
        mx = torch.where(i < nsplit, torch.maximum(mx, m), mx)
    num = torch.zeros_like(acc0)
    den = torch.zeros_like(s0)
    for i, (m, s, acc) in enumerate(parts):
        w = torch.where(i < nsplit, torch.exp(m - mx), 0.0)
        num = num + w * acc
        den = den + w * s
    return torch.where(nsplit == 1, acc0 / s0, num / den)


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
    split: Optional[int] = None,
) -> torch.Tensor:
    """Flash-decode attention over the ring cache → (B, n_kv, group, hd) f32.

    The split-K online-softmax recurrence of the reference's
    ``decode_attention_ref`` (``_flash_decode``) over cache blocks of
    ``bk`` ring slots, with key positions read from ``k_pos``.  Blocks past
    ``pos // bk`` are skipped (the length-aware skip).  ``block=None`` is
    one whole-cap block.  ``split`` is the CUDA kernel's split order
    (``_flash_decode``; ``None``, the reference's, is one recurrence).
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
                         quantized=quantized, split=split)


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
    split: Optional[int] = None,
) -> torch.Tensor:
    """Flash-decode attention over the paged block pool →
    (B, n_kv, group, hd) f32: the reference's
    ``paged_decode_attention_ref``.

    The same recurrence as ``decode_attention_ref`` (``_flash_decode``)
    with the tile pinned to the pool block ``bs``: logical block j of slot
    b is physical block ``block_tables[b, min(j, pos // bs)]``, and the key
    position of in-block slot t is the implicit ``j·bs + t`` (the pool is
    append-only, so there is no stored k_pos).  For ``bs == bk`` it is bit
    for bit the ring recurrence on the same token stream, with or without
    the kernels' ``split`` (``_flash_decode``).
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
                         quantized=quantized, split=split)


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
    split: Optional[int] = None,
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
                              v_scale, window=window, block=block,
                              split=split)
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
    split: Optional[int] = None,
) -> torch.Tensor:
    """Multi-token verify attention over the paged block pool →
    (B, kq, n_kv, group, hd) f32: the reference's
    ``paged_verify_attention_ref``, ``paged_decode_attention_ref`` once
    per query row at ``pos + t``, stacked on axis 1 (see
    ``verify_attention_ref`` on why the rows stay separate)."""
    pos = pos.to(torch.int32)
    return torch.stack(
        [paged_decode_attention_ref(q[:, t], k, v, block_tables, pos + t,
                                    k_scale, v_scale, window=window,
                                    split=split)
         for t in range(q.shape[1])], dim=1)
