"""The single matmul entry point of the port's model layers (counterpart of
the reference's ``numerics/policy.py:dense``).

Only the policy-free path is ported: ``dense(x, w)`` is ``x @ w``.  The
paper's quantised-matmul policy (``QuantPolicy``, ``qmatmul`` and its
kernels) is ROADMAP Queue 1 item 9; any enabled policy raises.
"""

from __future__ import annotations

import torch

__all__ = ["dense", "matmul"]


def dense(x: torch.Tensor, w: torch.Tensor, policy=None, counter=0,
          seed: int = 0) -> torch.Tensor:
    """``x (..., d_in) @ w (d_in, d_out)`` in the operands' dtype, with f32
    accumulation.

    On the card this is cuBLAS's bf16 GEMM.  On the CPU the product runs in
    f32 and rounds once to the operands' dtype — what XLA's CPU backend does
    for a bf16 dot — because torch's CPU bf16 kernel rounds a small share
    of its outputs differently.

    ``policy`` None (or one whose ``enabled`` is false) is the plain
    matmul; an enabled quantisation policy raises ``NotImplementedError``.
    ``counter`` and ``seed`` keep the reference's signature; the plain path
    ignores them.
    """
    if policy is not None and getattr(policy, "enabled", True):
        raise NotImplementedError(
            "quantised-matmul policies are not ported yet (ROADMAP Queue 1 "
            "item 9); serve with policy=None")
    return matmul(x, w)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` with f32 accumulation on every device: on the CPU
    bf16 operands are upcast and the result rounded once (see ``dense``)."""
    if a.device.type == "cpu" and a.dtype == torch.bfloat16:
        return torch.matmul(a.float(), b.float()).to(a.dtype)
    return torch.matmul(a, b)
