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
fixed ``PYTHONHASHSEED``); the port keeps that for parity.  On the
training mesh every rank must draw the same seeds, or the data replicas
drift apart: the train step broadcasts rank 0's (``leaf_seeds``) once,
and compresses each rank's block of a leaf as its slice of the global
leaf (global absmax over the groups that split it, global hash index).
"""

from __future__ import annotations

from typing import Any

from repro_torch import tree
from repro_torch.numerics.policy import QuantPolicy, fake_quant

__all__ = ["compress_grads", "leaf_seeds"]


def leaf_seeds(grads: Any) -> list:
    """Each leaf's seed, ``abs(hash(path)) % 2**30``, in flatten order."""
    return [abs(hash(tree.path_str(p))) % (1 << 30)
            for p, _ in tree.leaves_with_path(grads)]


def compress_grads(grads: Any, policy: QuantPolicy, counter, views=None,
                   groups=None, seeds=None) -> Any:
    """Apply per-tensor dither-rounded quantisation to every gradient leaf
    of two or more dims (vectors are left as they are).  On the training
    mesh, per leaf in flatten order: ``views`` (its ``ShardView``),
    ``groups`` (those that split it) and ``seeds`` (rank 0's)."""
    if policy is None or not policy.enabled:
        return grads
    flat_g = tree.leaves(grads)
    seeds = leaf_seeds(grads) if seeds is None else seeds
    views = views or [None] * len(flat_g)
    groups = groups or [()] * len(flat_g)
    flat = []
    for g, seed, view, grp in zip(flat_g, seeds, views, groups):
        if g.dim() < 2:  # tiny vectors: not worth compressing
            flat.append(g)
            continue
        flat.append(fake_quant(g, policy, counter, seed=seed, view=view,
                               groups=grp).to(g.dtype))
    return tree.unflatten(grads, flat)
