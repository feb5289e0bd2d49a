"""Quantisation policy of the port: the paper's dither rounding as the
numerics of every dense matmul (counterpart of the reference's
``numerics/policy.py``).

``QuantPolicy`` decides how each ``dense`` product of the model runs:

* ``scheme='none'`` — the plain matmul (``matmul``);
* ``scheme='dither'`` — §VIII 'separate': activations and weights are
  dither-rounded onto a k-bit grid (dynamic absmax range), multiplied and
  dequantised;
* ``scheme='stochastic'|'deterministic'`` — the baselines.

``backend`` says where the product runs.  ``"torch"`` (the default) is the
unfused fake-quant matmul in plain torch — the reference's default
``"jnp"`` under the port's name, so a flag means the same in both
packages.  Any other name is a kernel-dispatch backend (``"auto"``,
``"cuda"``, ``"torch-ref"``): the forward runs the fused quantise-and-
multiply of ``kernels/dispatch.matmul``, on the card the hand-written CUDA
kernel.  Gradients are straight-through (``qmatmul``'s backward uses the
full-precision operands).

Every step keeps the reference's dtypes, so the CPU tests hold the port to
the reference op by op: absmax and the normalised operands are computed in
the operands' dtype (bf16 when serving) and cast to f32 before the
quantiser, the rescale ``ax·aw`` is a bf16 product.  No step divides by a
Python number: torch divides a CUDA tensor by one as a multiplication by
its reciprocal, which is not IEEE division.

The counter i_s is a float32 scalar in ``qmatmul`` (exact below 2²⁴), as
in the reference, and the int32 cast of it in the fused path.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core import rounding
from repro_torch.kernels import dispatch
from repro_torch.kernels import dither_matmul as _dm

__all__ = ["QuantPolicy", "qmatmul", "dense", "fake_quant", "matmul"]


@dataclass(frozen=True)
class QuantPolicy:
    scheme: str = "none"          # none | dither | stochastic | deterministic
    bits: int = 8
    n_pulses: int = 16            # dither pulse count N (unfused backend)
    seed: int = 0
    # "torch" — the unfused fake-quant matmul (the reference's "jnp").
    # Anything else is a kernel-dispatch backend ("auto", "cuda",
    # "torch-ref"): the forward runs the fused §VIII 'separate' product.
    backend: str = dispatch.UNFUSED
    quantize_weights: bool = True
    quantize_acts: bool = True

    @property
    def enabled(self) -> bool:
        return self.scheme != "none"

    def with_seed(self, seed: int) -> "QuantPolicy":
        return replace(self, seed=seed)

    def resolved(self, device=None) -> "QuantPolicy":
        """Pin ``"auto"`` to a concrete backend for ``device`` (``cuda`` on
        the card, ``torch-ref`` on the CPU; with no device ``"auto"`` stays
        and each call picks by its operands).  The engine calls this once
        at build time."""
        return replace(self, backend=dispatch.resolve_policy_backend(
            self.backend, device))


def _counter_f32(counter) -> float:
    """The counter as the reference carries it: a float32 value."""
    if isinstance(counter, torch.Tensor):
        counter = counter.item()
    return float(np.float32(counter))


def _absmax_scale(x: torch.Tensor, bits: int):
    """Symmetric dynamic range: the scale mapping [-absmax, absmax] onto
    [0, 2^k−1], and absmax, both in x's dtype."""
    half = (1 << bits) - 1
    absmax = torch.clamp_min(torch.amax(torch.abs(x)), 1e-6)
    num = torch.tensor(half / 2.0, dtype=x.dtype, device=x.device)
    return torch.div(num, absmax), absmax


def _fake_quant(x: torch.Tensor, policy: QuantPolicy, counter: float,
                seed: int) -> torch.Tensor:
    """Round x onto the symmetric k-bit grid with the policy's scheme, in
    x's dtype (the reference's ``_fake_quant``)."""
    scale, _ = _absmax_scale(x, policy.bits)
    half_levels = float((1 << policy.bits) - 1) / 2.0
    scaled = x.to(torch.float32) * scale + half_levels   # → [0, 2^k−1]
    if policy.scheme == "deterministic":
        codes = rounding.deterministic_round(scaled)
    elif policy.scheme == "stochastic":
        idx = rounding._flat_index(x)
        u = rounding.hash_uniform(seed, idx, counter)
        fl = torch.floor(scaled)
        codes = fl + (u < scaled - fl).to(torch.float32)
    elif policy.scheme == "dither":
        idx = rounding._flat_index(x)
        slot = rounding.lcg_slot(counter, idx, policy.n_pulses, seed=seed)
        u = rounding.hash_uniform(rounding._u32(seed) ^ 0xD1CE, idx, counter)
        fl = torch.floor(scaled)
        codes = fl + rounding.dither_bit(scaled - fl, slot, u,
                                         policy.n_pulses)
    else:
        raise ValueError(f"unknown rounding scheme {policy.scheme!r}")
    codes = torch.clamp(codes, 0.0, 2.0 * half_levels)
    return ((codes - half_levels) / scale).to(x.dtype)


def _fused_matmul(x: torch.Tensor, w: torch.Tensor, policy: QuantPolicy,
                  seed: int, counter: float) -> torch.Tensor:
    """Forward through the fused dispatch matmul (§VIII 'separate').

    The kernel takes a static operand range while the policy scales by
    the dynamic absmax, so both operands are normalised to [-1, 1] first
    (the grid is ``_fake_quant``'s) and the product is scaled back.
    Dither pulse counts follow §VII (N_A = N, N_B = M), not
    ``policy.n_pulses``.  bf16 operands on the card take the CUDA kernel's
    policy entry, which normalises and rescales inside the kernel, with
    the weight's absmax computed once per weight
    (``dither_matmul.dither_matmul_scaled``, bit for bit this function's
    other route); anything else runs the torch ops around
    ``dispatch.matmul``."""
    kw = dict(bits=policy.bits, scheme=policy.scheme, counter=int(counter),
              seed=seed)
    if (x.dtype == w.dtype == torch.bfloat16
            and dispatch.resolve_backend(policy.backend, x) == "cuda"):
        return _dm.dither_matmul_scaled(x, w, _dm.weight_absmax(w), **kw)
    ax = torch.clamp_min(torch.amax(torch.abs(x)), 1e-6)
    aw = torch.clamp_min(torch.amax(torch.abs(w)), 1e-6)
    out = dispatch.matmul(
        (x / ax).to(torch.float32), (w / aw).to(torch.float32),
        a_range=(-1.0, 1.0), b_range=(-1.0, 1.0), backend=policy.backend,
        **kw)
    return (out * (ax * aw)).to(x.dtype)


def _qmatmul_forward(x, w, policy: QuantPolicy, seed: int, counter: float):
    if (policy.backend != dispatch.UNFUSED and x.dim() == 2
            and policy.quantize_acts and policy.quantize_weights):
        return _fused_matmul(x, w, policy, seed, counter)
    xq = _fake_quant(x, policy, counter, seed) if policy.quantize_acts else x
    wq = (_fake_quant(w, policy, counter, seed + 1)
          if policy.quantize_weights else w)
    return matmul(xq, wq)


class _QMatmul(torch.autograd.Function):
    """Quantised x @ w with the straight-through backward of the
    reference's ``_qmatmul_bwd``: full-precision gradients."""

    @staticmethod
    def forward(ctx, x, w, policy, seed, counter):
        ctx.save_for_backward(x, w)
        return _qmatmul_forward(x, w, policy, seed, counter)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = matmul(g, w.T)
        gw = matmul(x.reshape(-1, x.shape[-1]).T, g.reshape(-1, g.shape[-1]))
        return gx.to(x.dtype), gw.to(w.dtype), None, None, None


def qmatmul(x: torch.Tensor, w: torch.Tensor, policy: QuantPolicy,
            seed: int, counter=0.0) -> torch.Tensor:
    """Quantised x @ w with straight-through gradients.  ``counter`` is
    carried as a float32 value (exact for i_s < 2²⁴).  The ``"torch"``
    backend fake-quantises both operands and multiplies; any other routes
    a 2-D product through the fused dispatch matmul (same grid, same
    backward)."""
    return _QMatmul.apply(x, w, policy, seed, _counter_f32(counter))


def fake_quant(x: torch.Tensor, policy, counter=0, seed: int = 0
               ) -> torch.Tensor:
    """Round-to-grid helper with a straight-through gradient, for call
    sites that are not a matmul."""
    if policy is None or not policy.enabled:
        return x
    xq = _fake_quant(x, policy, _counter_f32(counter), policy.seed + seed)
    return x + (xq - x).detach()


def dense(x: torch.Tensor, w: torch.Tensor, policy=None, counter=0,
          seed: int = 0) -> torch.Tensor:
    """The single matmul entry point of every model layer: ``x (..., d_in)
    @ w (d_in, d_out)``.  ``policy`` None (or disabled) is the plain
    ``matmul``; otherwise the quantised product of ``qmatmul`` over the
    2-D ``(rows, d_in)`` view, with seed ``policy.seed + seed``."""
    if policy is None or not policy.enabled:
        return matmul(x, w)
    lead = x.shape[:-1]
    out = qmatmul(x.reshape(-1, x.shape[-1]), w, policy, policy.seed + seed,
                  counter)
    return out.reshape(*lead, w.shape[-1])


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` with f32 accumulation on every device.  On the card
    this is cuBLAS's GEMM.  On the CPU bf16 operands are multiplied in f32
    and the result rounded once to bf16 — what XLA's CPU backend does for a
    bf16 dot — because torch's CPU bf16 kernel rounds a small share of its
    outputs differently."""
    if a.device.type == "cpu" and a.dtype == torch.bfloat16:
        return torch.matmul(a.float(), b.float()).to(a.dtype)
    return torch.matmul(a, b)
