"""Partition rules for param / cache / batch trees (counterpart of the
reference's ``dist/sharding.py``).

A spec is a tuple with one entry per dim of its leaf: ``None``
(replicated), an axis name, or a tuple of axis names — the reference's
``PartitionSpec`` as a plain tuple.  A mesh is anything with axis names
and sizes: a ``DeviceMesh`` or a :class:`MeshShape`, which stands in for
the reference's ``AbstractMesh`` so the rules run without processes.

Megatron-style layout on a ('data', 'model') mesh (optionally with a
leading 'pod' DP axis):

* attention — QKV column-parallel, O row-parallel, keyed on head counts:
  ``wq``/``wo`` shard only when ``n_heads % tp == 0`` and ``wk``/``wv``
  only when ``n_kv_heads % tp == 0``;
* MLP / MoE experts — up/gate column-parallel (last dim), down
  row-parallel (second-to-last dim);
* embeddings — vocab-parallel;
* everything else (norms, biases on d_model, routers, SSM scan params) —
  replicated.

Every entry is divisibility-guarded against the mesh, so any (arch ×
mesh) combination yields a legal spec tree.  Serving shards by
:func:`serve_param_specs` (QKV only), which ``interop.shard_serve_params``
applies to one rank's weights; training by :func:`train_param_specs`,
which ``interop.shard_train_state`` applies to params, m and v.  Both go
through :func:`local_block`, the one slicing rule, and
:func:`shard_view` says where a rank's block sits in the global leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from repro_torch.dist.ctx import mesh_sizes

__all__ = ["MeshShape", "ShardView", "param_specs", "cache_specs",
           "batch_specs", "data_axes", "serve_param_specs",
           "serve_heads_shardable", "train_param_specs", "local_block",
           "shard_view", "spec_leaves", "Placement", "placements"]

_DP_AXIS_NAMES = ("pod", "data")


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices or processes."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


@dataclass(frozen=True)
class ShardView:
    """Where one rank's block of a tensor sits: the global ``shape`` and
    the block's ``offset`` in each dim.  The dither hash keys every
    element on its global row-major index (``core.rounding._flat_index``),
    so a shard rounds as the whole tensor would."""
    shape: Tuple[int, ...]
    offset: Tuple[int, ...]

    @classmethod
    def whole(cls, shape) -> "ShardView":
        return cls(tuple(int(n) for n in shape), (0,) * len(shape))


# leaf-name → (which dim shards on 'model' counted from the END, head-count
# attribute guarding it or None for plain dim divisibility)
_LAST, _SECOND_LAST = 1, 2
_TP_RULES = {
    "wq": (_LAST, "n_heads"),
    "bq": (_LAST, "n_heads"),
    "wk": (_LAST, "n_kv_heads"),
    "wv": (_LAST, "n_kv_heads"),
    "bk": (_LAST, "n_kv_heads"),
    "bv": (_LAST, "n_kv_heads"),
    "wo": (_SECOND_LAST, "n_heads"),
    "wg": (_LAST, None),
    "wu": (_LAST, None),
    "bu": (_LAST, None),
    "wd": (_SECOND_LAST, None),
    "in_proj": (_LAST, None),
    "out_proj": (_SECOND_LAST, None),
    "embed": (_SECOND_LAST, None),
    "lm_head": (_LAST, None),
}

_QKV = ("wq", "bq", "wk", "wv", "bk", "bv")


def _map_with_path(rule, tree: Any, path: Tuple = ()) -> Any:
    """``rule(path, leaf)`` over a tree of dicts / lists; a path entry is a
    dict key (str) or a list index (int)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(rule, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(rule, v, path + (i,))
                          for i, v in enumerate(tree))
    return rule(path, tree)


def data_axes(mesh):
    """The DP spec entry for this mesh: ('pod', 'data'), 'data', or None."""
    present = tuple(a for a in _DP_AXIS_NAMES if a in mesh_sizes(mesh))
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def _leaf_name(path) -> str:
    for key in reversed(path):
        if isinstance(key, str):
            return key
    return ""


def _replicated(ndim: int) -> tuple:
    return (None,) * ndim


def _tp(mesh) -> int:
    return int(mesh_sizes(mesh).get("model", 1))


def param_specs(params: Any, cfg, mesh) -> Any:
    """Spec tree mirroring ``params`` (leaves: anything with ``.shape``)."""
    return _map_with_path(param_rule(cfg, mesh), params)


def param_rule(cfg, mesh):
    """The rule of :func:`param_specs` for one leaf: ``rule(path, leaf)``
    → its spec."""
    tp = _tp(mesh)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        name = _leaf_name(path)
        if name in _TP_RULES and shape:
            from_end, head_attr = _TP_RULES[name]
            if from_end <= len(shape):
                dim = len(shape) - from_end
                guard = getattr(cfg, head_attr) if head_attr else shape[dim]
                if tp > 1 and guard % tp == 0 and shape[dim] % tp == 0:
                    spec = [None] * len(shape)
                    spec[dim] = "model"
                    return tuple(spec)
        return _replicated(len(shape))

    return rule


def train_param_specs(params: Any, cfg, mesh) -> Any:
    """Spec tree of the training layout (DESIGN.md §5): the reference's
    GSPMD placement, :func:`param_specs` itself — QKV and up/gate
    column-parallel, W_O and W_down row-parallel, embed and head by
    vocab, the MoE experts' ``wg``/``wu``/``wd`` (E, d, f) / (E, f, d) on
    their FFN dim, everything else replicated.  Its own name so that the
    training code states the layout it trains on."""
    return param_specs(params, cfg, mesh)


def _axes_block(entry, sizes, coords) -> Tuple[int, int]:
    """(number of blocks, this rank's block) of a spec entry: row-major
    over its axes."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    n, c = 1, 0
    for a in axes:
        n, c = n * int(sizes[a]), c * int(sizes[a]) + int(coords[a])
    return n, c


def local_block(leaf, spec, sizes: dict, coords: dict):
    """One rank's block of a global leaf under ``spec``: each sharded dim
    narrowed to the contiguous block at the rank's coordinates
    (``coords``: axis name → coordinate), as a contiguous copy of its own
    (a block of leading rows is contiguous already, and ``contiguous``
    would keep the whole global storage alive behind it); a replicated
    leaf is the leaf itself."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n, c = _axes_block(entry, sizes, coords)
        size = leaf.shape[dim] // n
        leaf = leaf.narrow(dim, c * size, size).clone(
            memory_format=torch.contiguous_format)
    return leaf


def shard_view(global_shape, spec, sizes: dict, coords: dict) -> ShardView:
    """The :class:`ShardView` of one rank's block of a leaf of
    ``global_shape`` under ``spec``."""
    off = []
    for dim, n_g in enumerate(global_shape):
        entry = spec[dim] if dim < len(spec) else None
        if entry is None:
            off.append(0)
            continue
        n, c = _axes_block(entry, sizes, coords)
        off.append(c * (int(n_g) // n))
    return ShardView(tuple(int(n) for n in global_shape), tuple(off))


@dataclass(frozen=True)
class Placement:
    """Where a rank's block of one leaf lives: its spec, the mesh's axis
    sizes and the rank's coordinates (the port's counterpart of a
    ``NamedSharding`` for ``Checkpointer.restore``)."""
    spec: tuple
    sizes: tuple
    coords: tuple

    def local(self, leaf):
        """The rank's block of the global ``leaf``."""
        return local_block(leaf, self.spec, dict(self.sizes),
                           dict(self.coords))


def placements(specs: Any, mesh, coords: dict) -> Any:
    """A spec tree → a tree of :class:`Placement` for the rank at
    ``coords`` (axis name → coordinate) on ``mesh``."""
    sizes = tuple(sorted(mesh_sizes(mesh).items()))
    crd = tuple(sorted((a, int(c)) for a, c in coords.items()))

    def one(spec):
        return Placement(tuple(spec), sizes, crd)

    if isinstance(specs, dict):
        return {k: placements(v, mesh, coords) for k, v in specs.items()}
    if isinstance(specs, list):
        return [placements(v, mesh, coords) for v in specs]
    return one(specs)


def spec_leaves(specs: Any) -> list:
    """A spec tree's specs in ``repro_torch.tree`` flatten order (dict keys
    sorted, lists in order), one a leaf."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]


def serve_heads_shardable(cfg, tp: int) -> bool:
    """Can the serving engine split attention heads across a ``tp``-way
    'model' axis?  Requires the KV head count to divide (otherwise the
    engine keeps the heads replicated: the GQA fallback, DESIGN.md §9)."""
    return tp > 1 and cfg.n_kv_heads > 0 and cfg.n_kv_heads % tp == 0 \
        and cfg.n_heads % tp == 0


def serve_param_specs(params: Any, cfg, mesh) -> Any:
    """Spec tree of the serving layout (DESIGN.md §9): only the QKV
    projections shard (column-parallel on 'model', head-count guarded);
    W_O, the MLP, embeddings and norms stay replicated, so no f32
    contraction is split and no partial products are summed: the heads
    are all-gathered before W_O instead (``ctx.gather_heads``)."""
    tp = _tp(mesh)
    shardable = serve_heads_shardable(cfg, tp)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        if shardable and shape and _leaf_name(path) in _QKV \
                and shape[-1] % tp == 0:
            return (None,) * (len(shape) - 1) + ("model",)
        return _replicated(len(shape))

    return _map_with_path(rule, params)


# cache leaves whose entry-local dim 2 is a (KV) head dim: (B, S, H, hd) ring
# KV, quantised KV scales, cross-attention caches — and, paged,
# (n_blocks+1, bs, H, hd) pool arrays; SSM state "h" carries heads at
# entry-local dim 1: (B, nh, hd, n).
_HEADS_AT_2 = {"k", "v", "k_scale", "v_scale", "cross_k", "cross_v"}
_HEADS_AT_1 = {"h"}
# tree keys under which cache entries carry a leading stack axis; the
# "remainder" entries do not.  "cross" holds the port's encoder-decoder
# cross-KV, ``{"k", "v"}`` (L, B, T, n_kv, hd): the reference's stacked
# ``cross_k`` / ``cross_v`` under one key
_STACKED_KEYS = {"layers", "self", "cross_k", "cross_v", "cross"}


def cache_specs(cache: Any, cfg, mesh) -> Any:
    """Spec tree for decode caches (ring and paged): the per-slot batch dim
    (and the paged layout's pool-block axis) → DP axes, KV/SSM head dims →
    'model'; every entry divisibility-guarded (DESIGN.md §9).  Stacked
    entries carry a leading repeat axis that is never sharded.  A paged
    pool is ``data_shards`` shard-local pools of ``num_blocks + 1`` blocks
    back to back, so its block axis shards on the DP axes."""
    sizes = mesh_sizes(mesh)
    dp = data_axes(mesh)
    dp_tuple = dp if isinstance(dp, tuple) else ((dp,) if dp else ())
    dp_size = math.prod(int(sizes[a]) for a in dp_tuple) if dp_tuple else 1
    tp = int(sizes.get("model", 1))

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        name = _leaf_name(path)
        off = 1 if any(isinstance(k, str) and k in _STACKED_KEYS
                       for k in path) else 0
        spec = [None] * len(shape)
        if dp and dp_size > 1 and off < len(shape) \
                and shape[off] % dp_size == 0:
            spec[off] = dp
        head_dim = (2 if name in _HEADS_AT_2 else
                    1 if name in _HEADS_AT_1 else None)
        if head_dim is not None:
            head_dim += off
            if head_dim < len(shape) and tp > 1 \
                    and shape[head_dim] % tp == 0:
                spec[head_dim] = "model"
        return tuple(spec)

    return _map_with_path(rule, cache)


def batch_specs(cfg, mesh) -> dict:
    """Specs for training/prefill batches: batch dim on the DP axes."""
    dp = data_axes(mesh)
    return {"tokens": (dp, None), "labels": (dp, None),
            "embeds": (dp, None, None), "frames": (dp, None, None)}
