"""Carry the JAX package's parameters, train states and caches (ring or
paged) over to the port.

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

from repro_torch.tree import tree_map

__all__ = ["tensor_from_numpy", "params_from_numpy", "cache_from_numpy",
           "train_state_from_numpy", "shard_serve_params"]


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    """One numpy array → tensor on ``device``; bf16 exactly."""
    arr = np.array(arr, order="C")     # a C-ordered copy; keeps 0-d as 0-d
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


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
    """A reference decode cache → the port's on ``device``, bit for bit:
    a ring cache (``pos``, stacked ``layers``, ``remainder``), a paged
    one (the same plus ``block_tables``; each layer's pool includes its
    trailing trash block) or the encoder-decoder's (``pos``, ``self``,
    ``cross_k``, ``cross_v`` → ``pos``, ``layers`` = [``self``],
    ``remainder`` = [], ``cross`` = {``k``, ``v``})."""
    if "self" in tree:
        tree = {"pos": tree["pos"], "layers": [tree["self"]],
                "remainder": [],
                "cross": {"k": tree["cross_k"], "v": tree["cross_v"]}}
    return _tree(tree, device)


def train_state_from_numpy(tree, device="cuda"):
    """A reference train state ``{params, opt: {m, v, step}, counter}`` →
    the port's on ``device``, bit for bit (``step`` and ``counter`` stay
    0-d int32 tensors), so both packages compute the same step from it."""
    return _tree(tree, device)


def shard_serve_params(params, cfg, mesh_coords: dict, mesh):
    """The full param tree → one rank's local tree of sharded serving
    (DESIGN.md §9): each leaf that ``dist.sharding.serve_param_specs``
    shards on 'model' (the QKV projections and biases, when the head
    counts divide) keeps the contiguous block of heads at the rank's
    'model' coordinate ``mesh_coords["model"]``, as a contiguous copy;
    every other leaf is the full tensor itself.  ``mesh`` gives the axis
    sizes (a ``DeviceMesh`` or a ``MeshShape``)."""
    from repro_torch.dist import sharding
    from repro_torch.dist.ctx import mesh_sizes

    sizes = mesh_sizes(mesh)
    specs = sharding.serve_param_specs(params, cfg, mesh)

    def local(leaf, spec):
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n, c = 1, 0
            for a in axes:                   # row-major over the axes
                n, c = n * sizes[a], c * sizes[a] + int(mesh_coords[a])
            size = leaf.shape[dim] // n
            leaf = leaf.narrow(dim, c * size, size).contiguous()
        return leaf

    return tree_map(local, params, specs)
