"""Unbiased gradient compression with dither rounding (beyond-paper
feature): the port's counterpart of the reference's
``optim/grad_compress.py``.

The paper's estimator is exactly what gradient compression needs: an
*unbiased* low-bit representation with O(1/N²) EMSE.  Gradients are
fake-quantised to k-bit codes with dither rounding at the gradient
boundary (where a data-parallel run would reduce them); because the
rounding is unbiased, SGD convergence guarantees survive, and the step
counter walks the pulse sequence so quantisation error time-averages at
O(1/N) instead of Ω(1/√N).

Each leaf's seed is ``abs(hash(path)) % 2**30`` of its JAX key path string
(``['blocks']/[0]/['attn']/['wq']``), as the reference computes it, so in
one process both packages draw the same seeds.  Python salts ``hash()``
per process, so a compressed run repeats only within a process (or under a
fixed ``PYTHONHASHSEED``); the port keeps that for parity.
"""

from __future__ import annotations

from typing import Any

from repro_torch import tree
from repro_torch.numerics.policy import QuantPolicy, fake_quant

__all__ = ["compress_grads"]


def compress_grads(grads: Any, policy: QuantPolicy, counter) -> Any:
    """Apply per-tensor dither-rounded quantisation to every gradient leaf
    of two or more dims (vectors are left as they are)."""
    if policy is None or not policy.enabled:
        return grads
    paths = [p for p, _ in tree.leaves_with_path(grads)]
    flat = []
    for path, g in zip(paths, tree.leaves(grads)):
        if g.dim() < 2:  # tiny vectors: not worth compressing
            flat.append(g)
            continue
        seed = abs(hash(tree.path_str(path))) % (1 << 30)
        flat.append(fake_quant(g, policy, counter, seed=seed).to(g.dtype))
    return tree.unflatten(grads, flat)
