"""Pulse-sequence representations of reals in [0, 1] (paper §II): the
port's counterpart of the reference's ``core/representations.py``.

Three schemes, each mapping x ∈ [0,1] to an N-bit pulse sequence whose mean
estimates x:

* ``stochastic_encode``    — §II-A: iid Bernoulli(x) pulses.  Unbiased,
  Var = x(1-x)/N = Ω(1/N).
* ``deterministic_encode`` — §II-B: unary counting (Format 1) or evenly-spread
  (Format 2).  Var = 0, |bias| ≤ 1/(2N).
* ``dither_encode``        — §II-D: n = ⌊Nx⌋ deterministic 1-pulses under a
  permutation σ plus Bernoulli(δ) residual pulses.  Unbiased,
  Var ≤ 2/N² = Θ(1/N²).

All functions are vectorised over arbitrary leading batch dims of a tensor
``x`` and run on its device; the pulse axis is appended last.  Where the
reference takes a ``jax.random`` key the port takes a ``torch.Generator``
on x's device.  Each random encoder is the deterministic per-pulse
probability (``stochastic_probs``, ``dither_probs``) and one draw
``u < p``; the draw takes an optional ``u=`` of shape ``x.shape + (N,)``,
so a caller can feed in the uniforms of its choice (the tests feed the
reference's ``jax.random.uniform(key, shape)`` and compare bit for bit).
Every step is the reference's f32 op in its order; divisions are true
divisions by tensors (a CUDA tensor divided by a Python number is a
multiplication by its reciprocal).
"""

from __future__ import annotations

from typing import Literal, Optional

import torch

from repro_torch.core.rounding import _coprime_multiplier

Format = Literal["unary", "spread"]

__all__ = [
    "stochastic_encode",
    "deterministic_encode",
    "dither_encode",
    "dither_probs",
    "stochastic_probs",
    "decode",
    "lcg_permutation",
    "spread_ones",
]


def _f32(x) -> torch.Tensor:
    """x as a float32 tensor (a tensor keeps its device; anything else
    lands on the CPU)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(x, dtype=torch.float32)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def _draw(gen: Optional[torch.Generator], p: torch.Tensor,
          u: Optional[torch.Tensor]) -> torch.Tensor:
    """Pulses ``u < p`` in f32; ``u`` drawn from ``gen`` unless given."""
    if u is None:
        u = torch.rand(p.shape, generator=gen, device=p.device)
    elif tuple(u.shape) != tuple(p.shape):
        raise ValueError(f"u has shape {tuple(u.shape)}, the pulses "
                         f"{tuple(p.shape)}")
    return (u.to(p.device) < p).to(torch.float32)


def decode(pulses: torch.Tensor) -> torch.Tensor:
    """Estimate x from its pulse sequence: X_s = (1/N) Σ X_i (paper §II)."""
    return torch.mean(pulses.to(torch.float32), dim=-1)


# ---------------------------------------------------------------------------
# §II-A stochastic computing
# ---------------------------------------------------------------------------


def stochastic_probs(x, n_pulses: int) -> torch.Tensor:
    """P(X_i = 1) = x for every pulse: x broadcast to x.shape + (N,)."""
    x = _f32(x)
    return x[..., None].expand(*x.shape, n_pulses)


def stochastic_encode(gen: Optional[torch.Generator], x, n_pulses: int, *,
                      u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """iid Bernoulli(x) pulses: P(X_i = 1) = x.  Shape: x.shape + (N,)."""
    return _draw(gen, stochastic_probs(x, n_pulses), u)


# ---------------------------------------------------------------------------
# §II-B deterministic variant (Jenson & Riedel)
# ---------------------------------------------------------------------------


def spread_ones(n_ones, n_pulses: int,
                phase: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Evenly-spread placement of ``n_ones`` 1-bits among N slots (Format 2).

    Slot i carries a 1 iff ⌊(i+1)·m/N⌋ ≠ ⌊i·m/N⌋ (a Bresenham spread placing
    exactly m ones as uniformly as possible) — the paper's §III-B rule
    "P(Y_i)=1 if ⌊iy⌋ ≠ ⌊(i+1)y⌋" with y = m/N.  ``phase`` (∈[0,1), optional)
    rotates the pattern — the paper's random offset T.
    """
    m = _f32(n_ones)[..., None]
    n = _scalar(n_pulses, m)
    i = torch.arange(n_pulses, dtype=torch.float32, device=m.device)
    if phase is not None:
        # jnp.mod of non-negative operands: the exact fmod
        i = torch.fmod(i + _f32(phase).to(m.device)[..., None] * n_pulses, n)
    return (torch.floor((i + 1.0) * m / n) != torch.floor(i * m / n)).to(
        torch.float32)


def deterministic_encode(x, n_pulses: int, fmt: Format = "unary"
                         ) -> torch.Tensor:
    """Deterministic variant of SC (§II-B, §III-B).

    Format 1 ("unary"):  first R = round(Nx) slots are 1.
    Format 2 ("spread"): R ones spread as evenly as possible (for the right
    operand of a multiply).
    """
    x = _f32(x)
    r = torch.round(n_pulses * x)        # half to even, as jnp.round
    if fmt == "unary":
        i = torch.arange(n_pulses, dtype=torch.float32, device=x.device)
        return (i < r[..., None]).to(torch.float32)
    return spread_ones(r, n_pulses)


# ---------------------------------------------------------------------------
# §II-D dither computing
# ---------------------------------------------------------------------------


def lcg_permutation(n_pulses: int, offset: int = 0,
                    device="cuda") -> torch.Tensor:
    """A fixed permutation σ of {0..N-1}: σ(i) = (a·i + offset) mod N,
    gcd(a,N)=1 (int32 on ``device``).

    Used as the paper's σ; linear-congruential so both σ and σ⁻¹ are O(1)
    integer math (the production kernels never materialise this array).
    """
    a = _coprime_multiplier(n_pulses)
    i = torch.arange(n_pulses, dtype=torch.int64, device=device)
    return ((a * i + offset) % n_pulses).to(torch.int32)


def dither_probs(x, n_pulses: int, fmt: Format = "unary",
                 phase: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P(X_j = 1) of every pulse j of the §II-D dither representation,
    x.shape + (N,), deterministic in x (and ``phase``).

    For x ∈ [0, 1/2]:  n = ⌊Nx⌋, r = x − n/N, δ = Nr/(N−n):
        P(X_{σ(i)}=1) = 1 for i ≤ n,   δ for i > n.
    For x ∈ (1/2, 1]:  n = ⌈Nx⌉, r = n/N − x, δ = rN/n:
        P(X_{σ(i)}=1) = 1−δ for i ≤ n, 0 for i > n.

    ``fmt='unary'`` uses the identity permutation (Format 1, left operand);
    ``fmt='spread'`` spreads the deterministic slots evenly (Format 2, right
    operand of a multiply, §III-C) with optional random phase T.
    """
    x = _f32(x)
    N = n_pulses
    nt = _scalar(N, x)

    lo = x <= 0.5
    # -- low branch ---------------------------------------------------------
    n_lo = torch.floor(N * x)
    r_lo = x - n_lo / nt
    delta_lo = torch.where(N - n_lo > 0,
                           N * r_lo / torch.clamp_min(N - n_lo, 1.0), 0.0)
    # -- high branch --------------------------------------------------------
    n_hi = torch.ceil(N * x)
    r_hi = n_hi / nt - x
    delta_hi = torch.where(n_hi > 0, r_hi * N / torch.clamp_min(n_hi, 1.0),
                           0.0)

    n = torch.where(lo, n_lo, n_hi)[..., None]
    # P(pulse at deterministic-slot positions), P(pulse at residual positions)
    p_head = torch.where(lo, 1.0, 1.0 - delta_hi)[..., None]
    p_tail = torch.where(lo, delta_lo, 0.0)[..., None]

    # Slot occupancy: position j is a "head" slot iff σ⁻¹(j) < n.  With the
    # spread format head slots are placed evenly (Bresenham) instead.
    if fmt == "unary":
        j = torch.arange(N, dtype=torch.float32, device=x.device)
        is_head = j < n
    elif fmt == "spread":
        if phase is None:
            phase = torch.zeros(x.shape, dtype=torch.float32,
                                device=x.device)
        is_head = spread_ones(n[..., 0], N, phase=phase) > 0.5
    else:
        raise ValueError(f"unknown pulse format {fmt!r}")
    return torch.where(is_head, p_head, p_tail)


def dither_encode(gen: Optional[torch.Generator], x, n_pulses: int,
                  fmt: Format = "unary",
                  phase: Optional[torch.Tensor] = None, *,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dither-computing encoding (paper §II-D), vectorised: the pulses
    ``u < dither_probs(x, ...)``.  Both branches are unbiased with
    Var(X_s) ≤ 2/N²."""
    return _draw(gen, dither_probs(x, n_pulses, fmt, phase), u)
