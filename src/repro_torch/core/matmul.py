"""k-bit quantised matrix multiplication with the rounding-scheme variants
of the paper (§VII Fig. 7 and §VIII): the reference's ``core/matmul.py``
in torch.

Three placements of the rounding for C = A·B, A: p×q, B: q×r:

* ``per_partial``  — every partial product A_ij·B_jk rounds both operands
  (2·pqr roundings).  For dither rounding N_A = r and N_B = p: element
  A_ij is used r times (once per output column, the counter), B_jk p
  times (once per output row).
* ``round_a_once`` — A rounded once per element, B per partial product.
* ``separate``     — both matrices rounded once, then a plain product
  ((p+r)q roundings): the variant that scales to deep learning.  It goes
  through ``kernels/dispatch.matmul`` — on the card the hand-written CUDA
  dither-matmul kernel — and is bitwise the reference's.

The research variants are plain torch: their codes are the reference's
bit for bit, their real-domain map back within float rounding of it.
"""

from __future__ import annotations

from typing import Literal, Optional

import numpy as np
import torch

from repro_torch.core import rounding
from repro_torch.core.quantizers import QuantSpec, quantize, scaled_codes
from repro_torch.kernels import dispatch
from repro_torch.kernels.ref import fma_f32

Variant = Literal["per_partial", "round_a_once", "separate"]
Scheme = Literal["deterministic", "stochastic", "dither"]

__all__ = ["quantized_matmul", "matmul_error"]


def _codes_expanded(x: torch.Tensor, spec: QuantSpec, scheme: str,
                    counter_axis_len: int, counter_on: str, n_pulses: int,
                    seed: int, counter0=0) -> torch.Tensor:
    """Round every *use* of x: codes of shape x.shape + (L,) for
    ``counter_on='new_last'`` (A: counter = output column) or (L,) +
    x.shape for ``'new_first'`` (B: counter = output row), the use index
    along the new axis being the hash counter, phase-shifted by the global
    counter ``counter0``.  Deterministic rounding is use-independent."""
    scaled = scaled_codes(x, spec)
    fl = torch.floor(scaled)
    f = scaled - fl
    L = counter_axis_len
    dev = x.device
    uses = (torch.arange(L, dtype=torch.int64, device=dev)
            + rounding._u32(counter0)) & 0xFFFFFFFF
    flat = rounding._flat_index(scaled)
    if counter_on == "new_last":
        fl_e, f_e, counter, idx = fl[..., None], f[..., None], uses, \
            flat[..., None]
        shape = x.shape + (L,)
    else:
        fl_e, f_e, idx = fl[None], f[None], flat[None]
        counter = uses.reshape((L,) + (1,) * x.dim())
        shape = (L,) + tuple(x.shape)
    if scheme == "deterministic":
        det = rounding.deterministic_round(scaled)
        codes = (det[..., None] if counter_on == "new_last"
                 else det[None]).expand(shape)
    elif scheme == "stochastic":
        u = rounding.hash_uniform(seed, idx, counter)
        codes = fl_e + (u < f_e).to(torch.float32)
    elif scheme == "dither":
        slot = rounding.lcg_slot(counter, idx, n_pulses, seed=seed)
        u = rounding.hash_uniform(rounding._u32(seed) ^ 0xD1CE, idx, counter)
        codes = fl_e + rounding.dither_bit(f_e, slot, u, n_pulses)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    return torch.clamp(codes, 0, spec.levels)


def quantized_matmul(a: torch.Tensor, b: torch.Tensor, *, bits: int,
                     scheme: Scheme = "dither",
                     variant: Variant = "separate", seed: int = 0,
                     lo: float = 0.0, hi: float = 1.0, counter=0,
                     fmt: str = "spread",
                     backend: Optional[str] = None) -> torch.Tensor:
    """A·B through a k-bit fixed-point multiplier (§VII–§VIII), mapped back
    to the real domain; entries of A and B are taken in [lo, hi].
    ``separate`` runs on the dispatch backend (``backend`` None: by
    device); the research variants are plain torch."""
    if variant == "separate":
        return dispatch.matmul(a, b, bits=bits, scheme=scheme,
                               counter=counter, seed=seed, a_range=(lo, hi),
                               b_range=(lo, hi), fmt=fmt, backend=backend)
    p, q = a.shape
    q2, r = b.shape
    if q != q2:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    spec = QuantSpec(bits, lo, hi)
    if variant == "round_a_once":
        ca = quantize(a, spec, scheme, counter=counter, seed=seed,
                      n_pulses=max(r, 2), out_dtype=torch.float32)
        # B_jk rounded per partial product: counter = output row i, N_B = p
        cb = _codes_expanded(b, spec, scheme, p, "new_first", max(p, 2),
                             seed + 1, counter0=counter)
        cc = torch.einsum("ij,ijk->ik", ca.double(), cb.double())
        sum_a = ca.sum(dim=1)[:, None]
        sum_b = cb.sum(dim=1)
    elif variant == "per_partial":
        # A_ij rounded per use: counter = output column k, N_A = r
        ca = _codes_expanded(a, spec, scheme, r, "new_last", max(r, 2), seed,
                             counter0=counter)
        cb = _codes_expanded(b, spec, scheme, p, "new_first", max(p, 2),
                             seed + 1, counter0=counter)
        cc = torch.einsum("ijk,ijk->ik", ca.double(), cb.double())
        sum_a = ca.sum(dim=1)
        sum_b = cb.sum(dim=1)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    # x ≈ lo + code/s  ⇒  C[i,k] = cc/s² + (lo/s)·(Σ_j ca + Σ_j cb) + q·lo²,
    # as the compiled reference computes it (ref.dequant_constants): the
    # divisions by constants become f32 reciprocals, the first sum a fused
    # multiply-add
    one = np.float32(1.0)
    r_acc = float(one / np.float32(spec.scale * spec.scale))
    cc = cc.to(torch.float32)
    if lo == 0.0:
        return cc * r_acc
    c_lo = float(np.float32(lo) * (one / np.float32(spec.scale)))
    c = fma_f32(cc, r_acc, (sum_a + sum_b) * c_lo)
    return c + float(np.float32(q * lo * lo))


def matmul_error(a: torch.Tensor, b: torch.Tensor,
                 c_hat: torch.Tensor) -> torch.Tensor:
    """Frobenius error e_f = ‖AB − Ĉ‖_F (the paper's §VII metric)."""
    return torch.linalg.norm(a @ b - c_hat)
