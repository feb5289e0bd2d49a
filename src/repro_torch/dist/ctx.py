"""Ambient mesh context, and the two collectives of sharded serving
(counterpart of the reference's ``dist/ctx.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with axes
('data', 'model') — or ('pod', 'data', 'model') — or, where only its
shape matters, a :class:`repro_torch.dist.sharding.MeshShape`.
``mesh_context`` installs one as the ambient mesh for the size queries
(``axis_size``, ``tp_size``, ``dp_axes``, ``dp_shards``,
``seq_shard_attention``), as the reference's does.

Sharded serving (DESIGN.md §9) runs one process per shard, SPMD: every
rank runs the same host loop over the global slot table, and its device
holds only its data shard's slot rows and its model shard's KV heads.
Two things must stay functions of the *global* coordinates for a sharded
stream to be the single-device stream bit for bit, and the engine
installs :func:`serve_shard_scope` around its device work so that model
code finds them:

1. the int8 KV quantiser's element indices (the dither hash is keyed on
   the global head index, ``transformer._kv_elem_idx``), and
2. the attention heads, all-gathered over 'model' before the replicated
   W_O (:func:`gather_heads`), so every f32 contraction stays whole.

The host-state gather (:func:`gather_rows`) brings each data shard's
per-row outputs — sampled tokens, a window's token matrix, a verify
window's draws — to every rank, so every rank's host mirrors stay equal.
These two functions, and :func:`barrier` (after a snapshot write), are
the port's only calls into ``torch.distributed`` collectives; ``GATHERS``
counts the calls and bytes of each gather.  A collective must be called
the same number of times, with the same shapes, on every rank of its
group: the engine's host loop is the same on every rank, so it is.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

__all__ = [
    "mesh_context", "current_mesh", "mesh_sizes", "mesh_coordinate",
    "axis_size", "tp_size", "dp_axes", "dp_shards", "seq_shard_attention",
    "constrain", "serve_shard_scope", "kv_shard_info", "gather_heads",
    "gather_rows", "barrier", "GATHERS",
]

_MESH_STACK: list = []

# DP axes in outer-to-inner order; "model" is the TP axis (launch/mesh.py).
_DP_AXIS_NAMES = ("pod", "data")


@contextlib.contextmanager
def mesh_context(mesh):
    """Install ``mesh`` as the ambient mesh for the size queries."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def current_mesh():
    return _MESH_STACK[-1] if _MESH_STACK else None


def mesh_sizes(mesh) -> dict:
    """Axis name → size of a ``DeviceMesh`` or a ``MeshShape``."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    sizes = getattr(mesh, "axis_sizes", None) or tuple(mesh.shape)
    return {a: int(s) for a, s in zip(names, sizes)}


def mesh_coordinate(mesh) -> dict:
    """Axis name → this rank's coordinate on a ``DeviceMesh``; all zeros on
    a one-device ``MeshShape``, which needs no process."""
    if not hasattr(mesh, "get_coordinate"):
        sizes = mesh_sizes(mesh)
        if any(n != 1 for n in sizes.values()):
            raise ValueError(f"mesh shape {sizes} has no ranks: serve over a "
                             "DeviceMesh (launch/mesh.make_serve_mesh)")
        return {a: 0 for a in sizes}
    return {a: int(c) for a, c in zip(mesh.mesh_dim_names,
                                       mesh.get_coordinate())}


def axis_size(name: str) -> int:
    mesh = current_mesh()
    if mesh is None:
        return 1
    return int(mesh_sizes(mesh).get(name, 1))


def tp_size() -> int:
    """Tensor-parallel width (the 'model' mesh axis; 1 outside a mesh)."""
    return axis_size("model")


def dp_axes():
    """The data-parallel spec entry: ('pod', 'data') on multi-pod meshes,
    plain 'data' otherwise."""
    mesh = current_mesh()
    if mesh is None:
        return "data"
    present = tuple(a for a in _DP_AXIS_NAMES if a in mesh_sizes(mesh))
    if not present:
        return "data"
    return present if len(present) > 1 else present[0]


def dp_shards() -> int:
    """Total number of data-parallel shards under the current mesh."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    sizes = mesh_sizes(mesh)
    return int(math.prod(sizes.get(a, 1) for a in _DP_AXIS_NAMES))


def seq_shard_attention(n_heads: int) -> bool:
    """Sequence-parallel attention: used when TP is on but the (GQA) head
    count cannot split across the 'model' axis."""
    tp = tp_size()
    return tp > 1 and n_heads % tp != 0


def constrain(x: torch.Tensor, *entries) -> torch.Tensor:
    """Identity.  The reference's ``constrain`` is a sharding constraint
    for XLA's partitioner; eager torch has none, and the serving engine
    shards by running one process per shard, never through it.  What
    replaces it on the training mesh (DTensor placements or DDP) comes
    with the training mesh (ROADMAP Queue 1 item 10b)."""
    return x


# ---------------------------------------------------------------------------
# serve-time shard scope (one process per shard, DESIGN.md §9)
# ---------------------------------------------------------------------------

_SERVE_SHARD: list = []


@contextlib.contextmanager
def serve_shard_scope(*, head0: int, heads_sharded: bool, group=None):
    """Install this rank's per-shard → global map for the engine's device
    work.  ``head0`` is the shard's global KV-head offset (its 'model'
    coordinate times the local KV head count; 0 under the GQA fallback);
    ``heads_sharded`` records whether the 'model' axis splits the heads;
    ``group`` is the 'model' process group :func:`gather_heads` gathers
    over.  Batch rows need no offset: everything the model hashes is
    row-independent (``transformer._kv_elem_idx``)."""
    _SERVE_SHARD.append({"head0": int(head0),
                         "heads_sharded": bool(heads_sharded),
                         "group": group})
    try:
        yield
    finally:
        _SERVE_SHARD.pop()


def kv_shard_info() -> Optional[dict]:
    """The active serve shard scope (None outside sharded serving)."""
    return _SERVE_SHARD[-1] if _SERVE_SHARD else None


# calls and bytes received (all ranks' slabs) of each gather, this process
GATHERS = {"heads": {"calls": 0, "bytes": 0},
           "rows": {"calls": 0, "bytes": 0}}


def _all_gather(x: torch.Tensor, group, dim: int, kind: str) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in group-rank order
    (= mesh-coordinate order along the group's axis)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, src, group=group)
    GATHERS[kind]["calls"] += 1
    GATHERS[kind]["bytes"] += out.numel() * out.element_size()
    return out.movedim(0, dim).contiguous()


def gather_heads(x: torch.Tensor) -> torch.Tensor:
    """All-gather the attention-head dim of ``x`` (last axis) across the
    'model' group — identity outside sharded serving or under the GQA
    fallback.  The concatenation order is the global head order, so the
    gathered activation is bitwise the single-device one, and the W_O
    product after it contracts the full head dim on every rank instead of
    summing partial products (DESIGN.md §9)."""
    info = kv_shard_info()
    if info is None or not info["heads_sharded"]:
        return x
    return _all_gather(x, info["group"], x.dim() - 1, "heads")


def gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The host-state gather: every data shard's rows of ``x`` (a per-slot
    output: sampled tokens, a window's (n, B/dp) token matrix, a verify
    window's draws), concatenated along ``dim`` in data-shard order over
    the 'data' group, so every rank sees the global (…, B, …) result.
    Identity on a one-shard group (or ``group`` None)."""
    if group is None:
        return x
    return _all_gather(x, group, dim, "rows")


def barrier():
    """Every rank of the default process group meets here: the sharded
    engine's ranks after rank 0 wrote a snapshot, so that a rank restoring
    after a crash reads the same file as every other.  A no-op without a
    process group of more than one rank."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
