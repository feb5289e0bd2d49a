"""Nested dicts and lists of tensors ("trees") walked in JAX's order.

The port keeps params and train state as the reference's pytrees: dicts
(visited in sorted key order), lists or tuples (in order) and leaves
(tensors, numpy arrays, numbers); ``None`` holds no leaf.  Walking them as
``jax.tree_util`` does lets one checkpoint's leaves, and the per-leaf
seeds of ``optim/grad_compress.py``, line up in both packages.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["leaves", "leaves_with_path", "tree_map", "unflatten", "path_str"]


def leaves_with_path(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree_util.tree_flatten`` order; a path
    entry is a dict key (str) or a list index (int)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def path_str(path: Tuple) -> str:
    """``"/".join(str(k) for k in path)`` of the matching JAX key path:
    ``['blocks']/[0]/['attn']/['wq']``."""
    return "/".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]"
                    for k in path)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like: Any, flat: List[Any]) -> Any:
    """``like``'s structure with its leaves replaced, in flatten order, by
    ``flat``; raises if the counts differ."""
    flat = list(flat)
    n = len(leaves(like))
    if len(flat) != n:
        raise ValueError(f"{len(flat)} leaves for a structure of {n}")
    it = iter(flat)
    return tree_map(lambda _: next(it), _sorted(like))


def _sorted(tree: Any) -> Any:
    """Dicts rebuilt in sorted key order, so ``tree_map`` visits leaves in
    flatten order."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted(v) for v in tree)
    return tree
