"""k-bit fixed-point quantisation (paper §VII): the reference's
``core/quantizers.py`` in torch.

The paper's quantiser: q(x) = round(x) clipped to [0, 2^k − 1]; real inputs
in [lo, hi] are affinely rescaled to the code range first, rounded with one
of the three schemes, and (for analysis or dequantised arithmetic) mapped
back.  Codes are bitwise the reference's for the same f32 inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import rounding

__all__ = ["QuantSpec", "quantize", "dequantize", "quantize_dequantize"]


@dataclass(frozen=True)
class QuantSpec:
    """A k-bit affine quantiser over the real interval [lo, hi]."""

    bits: int
    lo: float = 0.0
    hi: float = 1.0

    @property
    def levels(self) -> int:
        return (1 << self.bits) - 1  # 2^k − 1 (top code)

    @property
    def scale(self) -> float:
        return self.levels / (self.hi - self.lo)


def _f32(v: float) -> float:
    return float(np.float32(v))


def _round(scaled: torch.Tensor, scheme: str, *, counter, seed,
           n_pulses: int) -> torch.Tensor:
    if scheme == "deterministic":
        return rounding.deterministic_round(scaled)
    if scheme == "stochastic":
        return rounding.stochastic_round(scaled, seed, counter)
    if scheme == "dither":
        return rounding.dither_round(scaled, counter, seed, n_pulses)
    raise ValueError(f"unknown rounding scheme {scheme!r}")


def scaled_codes(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """``(x - lo) · scale`` in f32, the constants rounded to f32 first as
    the reference's weakly typed ones are."""
    return (x.to(torch.float32) - _f32(spec.lo)) * _f32(spec.scale)


def quantize(x: torch.Tensor, spec: QuantSpec, scheme: str = "deterministic",
             *, counter=0, seed: int = 0, n_pulses: int = 16,
             out_dtype=torch.int32) -> torch.Tensor:
    """Real → integer codes in {0..2^k−1}, with under/overflow clipping."""
    codes = _round(scaled_codes(x, spec), scheme, counter=counter, seed=seed,
                   n_pulses=n_pulses)
    return torch.clamp(codes, 0, spec.levels).to(out_dtype)


def dequantize(codes: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Codes → reals: ``codes / scale + lo`` in f32, an IEEE division (by
    a tensor on the codes' device, never by a Python number, which torch
    turns into a multiplication by the reciprocal on the card)."""
    scale = torch.tensor(_f32(spec.scale), device=codes.device)
    return codes.to(torch.float32) / scale + _f32(spec.lo)


def quantize_dequantize(x: torch.Tensor, spec: QuantSpec,
                        scheme: str = "deterministic", *, counter=0,
                        seed: int = 0, n_pulses: int = 16) -> torch.Tensor:
    """The fake-quant round trip used for EMSE measurement and QAT."""
    return dequantize(quantize(x, spec, scheme, counter=counter, seed=seed,
                               n_pulses=n_pulses), spec)
