"""A frozen copy of the dither matmul policy's product, paper §VIII
'separate' with the pulse counts of §VII, as the configuration states it:

* each operand is normalised by its absmax (``max |t|``, at least 1e-6,
  in the operand's dtype) and taken in float32;
* both are dither-rounded onto the ``bits``-bit grid over (-1, 1): the
  activation x (M, K) with the product's seed and N_A = max(N, 2) pulses,
  the weight w (K, N) with seed + 1 and N_B = max(M, 2), each element's
  hash keyed on its row-major index and the product's counter;
* the codes are multiplied exactly on the integer grid, mapped back to
  (-1, 1)² by the grid's constants in float32 (one fused multiply-add,
  then the row and K terms), scaled by the two absmaxes and cast to x's
  dtype.

Copied from the scheme at the benchmark's first version and never
following the program: the CPU tests hold the port's plain product to it
bit for bit, and the dither cell's check holds the products the timed
path made to it (``bench/products.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from bench.reference import rounding

__all__ = ["product"]


def _codes(t: torch.Tensor, bits: int, seed: int, counter: int,
           n_pulses: int, row0: torch.Tensor) -> torch.Tensor:
    """Integer codes in [0, 2**bits − 1] of rows of a normalised operand;
    ``row0`` (R,) the global row of each, for the hash index."""
    levels = float((1 << bits) - 1)
    scale = float(np.float32(levels / 2.0))
    scaled = (t.to(torch.float32) + 1.0) * scale
    idx = row0[:, None] * t.shape[1] + torch.arange(
        t.shape[1], dtype=torch.int64, device=t.device)[None, :]
    fl = torch.floor(scaled)
    slot = rounding.lcg_slot(counter, idx, n_pulses, seed=seed)
    u = rounding.hash_uniform(rounding._u32(seed) ^ 0xD1CE, idx, counter)
    codes = fl + rounding.dither_bit(scaled - fl, slot, u, n_pulses)
    return torch.clamp(codes, 0.0, levels)


def _fma_f32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once, computed exactly in float64: the
    f64 product of two f32 values is exact, TwoSum gives the sum's error,
    and the sum is rounded to odd before the cast so that it is rounded
    once."""
    p = a.double() * b
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _absmax(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(torch.amax(torch.abs(t)), 1e-6)


@torch.no_grad()
def product(x: torch.Tensor, w: torch.Tensor, *, bits: int, seed: int,
            counter: int, rows: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Rows ``rows`` (default all) of the policy's product ``x @ w`` of a
    2-D x (M, K) and w (K, N), in x's dtype."""
    m, k = x.shape
    n = w.shape[1]
    dev = x.device
    rows = torch.arange(m, device=dev) if rows is None else rows.to(dev)
    ax, aw = _absmax(x), _absmax(w)
    a = (x[rows] / ax).to(torch.float32)
    ca = _codes(a, bits, seed, counter, max(n, 2), rows.to(torch.int64))
    cb = torch.cat([_codes((w[i:j] / aw).to(torch.float32), bits, seed + 1,
                           counter, max(m, 2),
                           torch.arange(i, j, dtype=torch.int64, device=dev))
                    for i, j in _blocks(k, n)])
    acc = (ca.double() @ cb.double()).to(torch.float32)
    rowsum = ca.sum(1, dtype=torch.float64).to(torch.float32)
    colsum = cb.sum(0, dtype=torch.float64).to(torch.float32)
    half = np.float32(((1 << bits) - 1) / 2.0)
    one = np.float32(1.0)
    r_acc = float(one / np.float32(float(half) * float(half)))
    c_lin = float(np.float32(-1.0) * (one / half))
    out = _fma_f32(acc, r_acc, (colsum * c_lin)[None, :])
    out = out + (rowsum * c_lin)[:, None]
    out = out + float(np.float32(k))
    return (out * (ax * aw)).to(x.dtype)


def _blocks(rows: int, cols: int, elems: int = 1 << 22):
    step = max(1, elems // max(1, cols))
    return [(i, min(rows, i + step)) for i in range(0, rows, step)]
