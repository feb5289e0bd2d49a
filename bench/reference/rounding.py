"""A frozen copy of the dither rounding (paper §II-D, §VII) and the
roundings built on it, for the reference's lower-precision controls.

The hash is a stateless murmur-style mix of (seed, element index,
counter); uint32 values are held in int64 tensors in [0, 2**32), every
product split into 16-bit halves so that no partial product overflows.
The functions are copied from the port at the benchmark's first version
and never follow it: the benchmark's tests hold the port's roundings to
them at 8 bits, and the controls run them at fewer.
"""

from __future__ import annotations

import torch

__all__ = ["hash_uniform", "lcg_slot", "dither_bit", "fake_quant",
           "kv_round", "fp8_round"]

_MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _u32(v):
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & _MASK
    return int(v) & _MASK


def _mul32(a, c: int):
    """(a * c) mod 2**32 for uint32 ``a`` and a constant ``c``."""
    if not isinstance(a, torch.Tensor):
        return (a * c) & _MASK
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix(h):
    """murmur3's fmix32."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def hash_uniform(seed, idx, counter) -> torch.Tensor:
    """A uniform in [0, 1), f32, from (seed, element index, counter)."""
    seed, idx, counter = _u32(seed), _u32(idx), _u32(counter)
    h = _mix(seed ^ _GOLDEN)
    h = _mix(h ^ _mul32(idx, _M1))
    h = _mix(h ^ _mul32(counter, _M2))
    if not isinstance(h, torch.Tensor):
        h = torch.tensor(h, dtype=torch.int64)
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
    """The pulse slot σ(i_s mod N): a linear-congruential permutation with
    a per-element phase."""
    a = _coprime_multiplier(n_pulses)
    counter, idx = _u32(counter), _u32(idx)
    n = int(n_pulses) & _MASK
    phase = _mix(idx ^ _u32(seed) ^ _GOLDEN)
    q = ((counter + phase) & _MASK) % n
    return ((_mul32(q, a) + (phase >> 8)) & _MASK) % n


def dither_bit(frac: torch.Tensor, slot: torch.Tensor, u: torch.Tensor,
               n_pulses: int) -> torch.Tensor:
    """The pulse X_σ(i) of the dither representation of ``frac`` in [0, 1]
    (§II-D): N pulses, ⌊N·frac⌋ or ⌈N·frac⌉ of them set, the rest a
    Bernoulli draw, so the bit's mean is ``frac``."""
    big_n = float(n_pulses)
    f = frac.to(torch.float32)
    slot = slot.to(torch.float32)
    lo = f <= 0.5
    n_lo = torch.floor(big_n * f)
    delta_lo = torch.where(big_n - n_lo > 0,
                           (big_n * f - n_lo) / torch.clamp_min(big_n - n_lo,
                                                                1.0), 0.0)
    n_hi = torch.ceil(big_n * f)
    delta_hi = torch.where(n_hi > 0,
                           (n_hi - big_n * f) / torch.clamp_min(n_hi, 1.0),
                           0.0)
    n = torch.where(lo, n_lo, n_hi)
    head = slot < n
    p = torch.where(lo, torch.where(head, 1.0, delta_lo),
                    torch.where(head, 1.0 - delta_hi, 0.0))
    return (u < p).to(torch.float32)


def _dither(scaled: torch.Tensor, idx, counter, seed: int,
            n_pulses: int) -> torch.Tensor:
    fl = torch.floor(scaled)
    slot = lcg_slot(counter, idx, n_pulses, seed=seed)
    u = hash_uniform(_u32(seed) ^ 0xD1CE, idx, counter)
    return fl + dither_bit(scaled - fl, slot, u, n_pulses)


def fake_quant(x: torch.Tensor, bits: int, scheme: str = "dither",
               counter: float = 0.0, seed: int = 0,
               n_pulses: int = 16) -> torch.Tensor:
    """``x`` rounded onto the symmetric ``bits``-bit grid of its absmax
    (2**bits − 1 levels over [−absmax, absmax]) by ``scheme`` ('dither'
    or 'deterministic', half up), returned in float32."""
    xf = x.to(torch.float32)
    half = float((1 << bits) - 1) / 2.0
    scale = half / torch.clamp_min(torch.amax(torch.abs(xf)), 1e-6)
    scaled = xf * scale + half
    if scheme == "deterministic":
        codes = torch.floor(scaled + 0.5)
    elif scheme == "dither":
        idx = torch.arange(x.numel(), dtype=torch.int64,
                           device=x.device).reshape(x.shape)
        codes = _dither(scaled, idx, counter, seed, n_pulses)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    codes = torch.clamp(codes, 0.0, 2.0 * half)
    return (codes - half) / scale


def kv_round(t: torch.Tensor, ctr: torch.Tensor, idx: torch.Tensor,
             seed: int, bits: int = 8):
    """K or V rounded per (position, head) to signed ``bits``-bit codes by
    dither rounding: ``(codes, scale)`` with ``t ≈ codes · scale / q``, q
    = 2**(bits−1) − 1.  ``ctr`` is the absolute position (+ a per-request
    offset) and ``idx`` the element index head · hd + lane, both
    broadcasting against ``t``.  At 8 bits this is the int8 KV cache's
    rounding."""
    q = float((1 << (bits - 1)) - 1)
    tf = t.to(torch.float32)
    scale = torch.amax(torch.abs(tf), dim=-1) + 1e-6
    scaled = tf / scale[..., None] * q + (q + 1.0)
    codes = _dither(scaled, idx, ctr, seed, 16)
    codes = torch.clamp(codes, 0.0, 2.0 * q + 1.0) - (q + 1.0)
    return codes, scale


def kv_dequant(codes: torch.Tensor, scale: torch.Tensor,
               bits: int = 8) -> torch.Tensor:
    """The values that ``kv_round``'s codes stand for, float32."""
    q = float((1 << (bits - 1)) - 1)
    return codes * (scale[..., None] * (1.0 / q))


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    absmax to 448, the format's largest value; returned in float32."""
    xf = x.to(torch.float32)
    scale = 448.0 / torch.clamp_min(torch.amax(torch.abs(xf)), 1e-12)
    return (xf * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
