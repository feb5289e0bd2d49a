"""Carry the JAX package's parameters and ring caches over to the port.

The reference hands them over as nested dicts/lists of numpy arrays (for
example ``jax.tree.map(numpy.asarray, params)``); nothing here imports JAX
or ``ml_dtypes``.  A bf16 leaf arrives as an ``ml_dtypes`` bfloat16 array:
it is recognised by its dtype name and converted bit for bit through a
16-bit integer view.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["tensor_from_numpy", "params_from_numpy", "cache_from_numpy"]


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    """One numpy array → tensor on ``device``; bf16 exactly."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def _tree(tree: Any, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def params_from_numpy(tree, device="cuda"):
    """The reference's params (``transformer.init_params`` layout, stacked
    ``(R, …)`` leaves included) → the port's params on ``device``."""
    return _tree(tree, device)


def cache_from_numpy(tree, device="cuda"):
    """A reference ring cache (``pos``, stacked ``layers``, ``remainder``)
    → the port's ring cache on ``device``."""
    return _tree(tree, device)
