"""The dither hash and pulse math of the reference's ``core/rounding.py``
(paper §II-C, §VII), bit for bit, in torch.

All randomness is a stateless murmur-style hash of (seed, element index,
counter), so the port reproduces the reference's integer outputs exactly:
hash outputs, dither slots and dither bits are pinned bitwise against the
reference in ``tests/test_torch_rounding.py``.

torch has no unsigned 32-bit arithmetic on the CPU, so a uint32 value is
held in an int64 tensor in ``[0, 2**32)``.  Two traps and what this module
does about them:

* **Products.**  The product of two 32-bit values needs 64 unsigned bits
  and overflows int64.  ``_mul32`` splits the constant into 16-bit halves,
  so every partial product stays below 2**48, and keeps the low 32 bits
  exactly.
* **Sums.**  ``(counter + phase) % n`` wraps at 2**32 *before* the modulo
  in uint32; every sum here is masked to 32 bits before ``%``.

Every function takes tensors or Python ints (masked to 32 bits the way the
reference's ``np.uint32(int(v) & 0xFFFFFFFF)`` does); tensors keep their
device.
"""

from __future__ import annotations

import torch

__all__ = [
    "hash_uniform",
    "lcg_slot",
    "slot_index",
    "dither_bit",
]

_MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _u32(v):
    """Coerce to the uint32-in-int64 form (two's complement for negative
    int32 input, as the reference's ``astype(uint32)``)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & _MASK
    return int(v) & _MASK


def _mul32(a, c: int):
    """``(a * c) mod 2**32`` for a uint32 ``a`` (tensor or int) and a
    constant ``c`` in [0, 2**32), with no int64 overflow: each partial
    product of ``a`` and a 16-bit half of ``c`` is below 2**48."""
    if not isinstance(a, torch.Tensor):
        return (a * c) & _MASK
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix(h):
    """murmur3 fmix32 on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    h = h ^ (h >> 16)
    return h


def hash_uniform(seed, idx, counter) -> torch.Tensor:
    """Stateless uniform in [0,1) f32 from (seed, element index, counter)."""
    seed, idx, counter = _u32(seed), _u32(idx), _u32(counter)
    h = _mix(seed ^ _GOLDEN)
    h = _mix(h ^ _mul32(idx, _M1))
    h = _mix(h ^ _mul32(counter, _M2))
    if not isinstance(h, torch.Tensor):
        h = torch.tensor(h, dtype=torch.int64)
    # 24-bit mantissa → exact float32 uniform on [0,1)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _coprime_multiplier(n: int) -> int:
    a = max(1, int(round(0.6180339887 * n))) | 1
    while _gcd(a, n) != 1:
        a += 2
    return a


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def lcg_slot(counter, idx, n_pulses: int, seed: int = 0):
    """σ(i_s mod N) with a linear-congruential permutation σ (per-element
    phase) — the reference's ``lcg_slot``, uint32 wraparound included."""
    a = _coprime_multiplier(n_pulses)
    counter, idx = _u32(counter), _u32(idx)
    n = int(n_pulses) & _MASK
    phase = _mix(idx ^ _u32(seed) ^ _GOLDEN)
    q = ((counter + phase) & _MASK) % n
    return ((_mul32(q, a) + (phase >> 8)) & _MASK) % n


def slot_index(counter, idx, n_pulses: int, seed: int = 0,
               fmt: str = "spread"):
    """σ(i_s mod N) for either pulse format: ``'spread'`` (Format 2, the
    LCG permutation of ``lcg_slot``) or ``'unary'`` (Format 1, identity σ
    with a per-element phase)."""
    if fmt == "spread":
        return lcg_slot(counter, idx, n_pulses, seed=seed)
    if fmt == "unary":
        counter, idx = _u32(counter), _u32(idx)
        phase = _mix(idx ^ _u32(seed) ^ _GOLDEN)
        return ((counter + phase) & _MASK) % (int(n_pulses) & _MASK)
    raise ValueError(f"unknown pulse format {fmt!r}")


def dither_bit(frac: torch.Tensor, slot: torch.Tensor, u: torch.Tensor,
               n_pulses: int) -> torch.Tensor:
    """Pulse value X_{σ(i)} of the §II-D dither representation, lazily.

    ``frac`` ∈ [0,1], ``slot`` = σ(i_s mod N) ∈ {0..N-1}, ``u`` ~ U[0,1).
    Every step is the reference's f32 op in the same order, so the bit is
    bitwise the reference's.

    x ≤ 1/2: n = ⌊Nx⌋, δ = (Nx − n)/(N − n):   bit = [slot < n] or Bern(δ)
    x > 1/2: n = ⌈Nx⌉, δ = (n − Nx)/n:          bit = [slot < n]·Bern(1−δ)
    """
    N = float(n_pulses)
    f = frac.to(torch.float32)
    slot = slot.to(torch.float32)

    lo = f <= 0.5
    n_lo = torch.floor(N * f)
    delta_lo = torch.where(N - n_lo > 0,
                           (N * f - n_lo) / torch.clamp_min(N - n_lo, 1.0),
                           0.0)
    n_hi = torch.ceil(N * f)
    delta_hi = torch.where(n_hi > 0,
                           (n_hi - N * f) / torch.clamp_min(n_hi, 1.0), 0.0)

    n = torch.where(lo, n_lo, n_hi)
    head = slot < n
    p = torch.where(
        lo,
        torch.where(head, 1.0, delta_lo),
        torch.where(head, 1.0 - delta_hi, 0.0),
    )
    return (u < p).to(torch.float32)
