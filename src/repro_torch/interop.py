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
           "train_state_from_numpy", "shard_serve_params",
           "shard_train_params", "shard_train_state", "gather_train_state",
           "train_state_shardings", "global_shapes", "shard_cache",
           "gather_cache"]


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
    return tree_map(lambda leaf, spec: sharding.local_block(
        leaf, spec, sizes, mesh_coords), params, specs)


def shard_cache(cache, cfg, mesh_coords: dict, mesh):
    """A global decode cache (ring, or the encoder-decoder's) → one rank's
    local cache on the training mesh: each leaf cut to its block of
    ``dist.sharding.cache_specs`` at ``mesh_coords`` (axis name →
    coordinate): the slot rows on the DP axes, the KV heads, the SSD
    state's heads and the RG-LRU state's width on 'model', where they
    divide.  Every leaf is a copy, the replicated ones too: decode
    updates the cache in place, and the rank's cache must not write
    through to the global one."""
    from repro_torch.dist import sharding
    from repro_torch.dist.ctx import mesh_sizes

    sizes = mesh_sizes(mesh)
    specs = sharding.cache_specs(cache, cfg, mesh)

    def cut(leaf, spec):
        block = sharding.local_block(leaf, spec, sizes, mesh_coords)
        return block.clone() if block is leaf else block

    return tree_map(cut, cache, specs)


def gather_cache(cache, cfg, mesh, like):
    """One rank's local cache (``shard_cache``'s) → the global one, on
    every rank: each leaf that ``cache_specs`` of the global cache
    ``like`` (its leaves need only ``.shape``) shards is all-gathered over
    the groups of its axes, in coordinate order.  Collectives: call it on
    every rank.  Identity on a one-rank mesh."""
    from repro_torch import tree as tree_mod
    from repro_torch.dist import sharding
    from repro_torch.dist.ctx import mesh_sizes

    if all(n == 1 for n in mesh_sizes(mesh).values()):
        return cache
    import torch.distributed as dist

    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    specs = sharding.cache_specs(like, cfg, mesh)

    def full(leaf, spec):
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            for axis in reversed(entry if isinstance(entry, tuple)
                                 else (entry,)):
                group = mesh.get_group(axis)
                n = dist.get_world_size(group)
                src = leaf.movedim(dim, 0).contiguous()
                out = src.new_empty((n * src.shape[0],) +
                                    tuple(src.shape[1:]))
                gather(out, src, group=group)
                leaf = out.movedim(0, dim).contiguous()
        return leaf

    return tree_mod.tree_map(full, cache, specs)


def _is_numpy_tree(tree) -> bool:
    from repro_torch import tree as tree_mod

    return not isinstance(tree_mod.leaves(tree)[0], torch.Tensor)


def shard_train_params(tree, cfg, mesh_coords: dict, mesh, like=None):
    """A tree shaped like the global params (the params, or one of AdamW's
    moments) → one rank's blocks on the training mesh (DESIGN.md §5):
    each leaf cut to its block of ``dist.sharding.train_param_specs`` at
    ``mesh_coords`` (axis name → coordinate).  ``like``: the global params
    the specs are read from, when ``tree`` is not they."""
    from repro_torch.dist import sharding
    from repro_torch.dist.ctx import mesh_sizes

    sizes = mesh_sizes(mesh)
    specs = sharding.train_param_specs(tree if like is None else like, cfg,
                                       mesh)
    return tree_map(lambda leaf, spec: sharding.local_block(
        leaf, spec, sizes, mesh_coords), tree, specs)


def shard_train_state(state, cfg, mesh_coords: dict, mesh, device=None):
    """A global train state ``{params, opt: {m, v, step}, counter}`` (port
    tensors, or the reference's numpy arrays, carried over bit for bit on
    ``device``) → one rank's local state on the training mesh: params, m
    and v each cut by :func:`shard_train_params`; ``step`` and
    ``counter`` whole.  A new state is made on the rank by
    ``train.trainer.init_train_state(mesh=, coords=)``, which never holds
    the global moments."""
    if _is_numpy_tree(state["params"]):
        state = train_state_from_numpy(state, device or "cuda")
    params = state["params"]

    def cut(tree):
        return shard_train_params(tree, cfg, mesh_coords, mesh, like=params)

    return {"params": cut(params),
            "opt": {"m": cut(state["opt"]["m"]), "v": cut(state["opt"]["v"]),
                    "step": state["opt"]["step"]},
            "counter": state["counter"]}


def gather_train_state(state, cfg, mesh):
    """One rank's local train state → the global one, on every rank: each
    leaf that ``train_param_specs`` of the global shapes shards on
    'model' all-gathered over the mesh's 'model' group, in coordinate
    order (data replicas hold equal blocks, so 'data' needs no gather).
    Collectives: call it on every rank, on the training loop's thread.
    Identity on a (1, 1) mesh."""
    from repro_torch import tree as tree_mod
    from repro_torch.dist import sharding
    from repro_torch.dist.ctx import mesh_sizes

    sizes = mesh_sizes(mesh)
    tp = int(sizes.get("model", 1))
    if tp == 1:
        return state
    import torch.distributed as dist

    group = mesh.get_group("model")
    params = state["params"]
    specs = sharding.train_param_specs(
        global_shapes(params, cfg, mesh), cfg, mesh)

    def full(leaf, spec):
        if "model" not in spec:
            return leaf
        dim = spec.index("model")
        src = leaf.movedim(dim, 0).contiguous()
        out = src.new_empty((tp * src.shape[0],) + tuple(src.shape[1:]))
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(out, src, group=group)
        return out.movedim(0, dim).contiguous()

    def whole(tree):
        return tree_mod.tree_map(full, tree, specs)

    return {"params": whole(params),
            "opt": {"m": whole(state["opt"]["m"]),
                    "v": whole(state["opt"]["v"]),
                    "step": state["opt"]["step"]},
            "counter": state["counter"]}


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


def global_shapes(params, cfg, mesh):
    """The global shapes (objects with ``.shape``) of a rank's local
    params on the training mesh: a leaf is widened ``tp``-fold on the dim
    its rule names where the spec rule shards the widened shape (the rules
    guard on head counts and on the global dim, so this is exactly where
    the global leaf is sharded)."""
    from repro_torch.dist import sharding
    from repro_torch.dist.ctx import mesh_sizes

    tp = int(mesh_sizes(mesh).get("model", 1))
    rule = sharding.param_rule(cfg, mesh)

    def widen(path, leaf):
        shape = list(leaf.shape)
        name = sharding._leaf_name(path)
        if tp > 1 and name in sharding._TP_RULES and shape:
            from_end, _ = sharding._TP_RULES[name]
            if from_end <= len(shape):
                cand = list(shape)
                cand[len(shape) - from_end] *= tp
                if "model" in rule(path, _Shape(cand)):
                    return _Shape(cand)
        return _Shape(shape)

    return sharding._map_with_path(widen, params)


def train_state_shardings(state, cfg, mesh, mesh_coords: dict):
    """A tree of ``dist.sharding.Placement`` matching this rank's local
    train state on ``mesh``: params, m and v at their
    ``train_param_specs`` blocks for the rank at ``mesh_coords``, ``step``
    and ``counter`` whole — the ``shardings`` of ``Checkpointer.restore``
    onto that mesh."""
    from repro_torch.dist import sharding

    params = state["params"]
    if int(dict(sharding.mesh_sizes(mesh)).get("model", 1)) > 1:
        params = global_shapes(params, cfg, mesh)
    specs = sharding.train_param_specs(params, cfg, mesh)
    tree_p = sharding.placements(specs, mesh, mesh_coords)
    whole = sharding.placements((), mesh, mesh_coords)
    return {"params": tree_p, "opt": {"m": tree_p, "v": tree_p,
                                      "step": whole},
            "counter": whole}
