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
``GATHERS`` counts the calls and bytes of each gather.  A collective
must be called the same number of times, with the same shapes, on every
rank of its group: the engine's host loop is the same on every rank, so
it is.

The training mesh (DESIGN.md §5) runs one process per shard too, with
explicit collectives at fixed points in place of the reference's GSPMD
partitioning: Megatron tensor parallelism on 'model' and data parallelism
on 'data'.  :func:`train_shard_scope` installs this rank's groups and
coordinates (:func:`train_shard`), and four autograd collectives carry
their own backward: :func:`copy_to_model` (identity, all-reduce back),
:func:`reduce_from_model` (all-reduce, identity back),
:func:`gather_from_model` (all-gather, back all-reduce-and-slice or just
slice), :func:`scatter_to_model` (this rank's slice, all-gather back) and
:func:`all_reduce_max` (the policy's absmax, no gradient).
:func:`all_reduce_sum` and :func:`all_reduce_mean` carry the exact
integer partials of kernel 6's K blocks and the gradient bucket.
``COLLECTIVES`` counts the calls and bytes of each kind.  Every quantity
the reference computes over a whole tensor (the policy's absmax and hash
index, kernel 6's pulse counts) stays global, so dither rounding is the
same on every shard.
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
    "gather_rows", "barrier", "GATHERS", "train_shard_scope", "train_shard",
    "train_shard_of", "TrainShard", "copy_to_model", "reduce_from_model",
    "gather_from_model", "scatter_to_model", "all_reduce_max",
    "all_reduce_sum", "all_reduce_mean", "COLLECTIVES",
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
    for XLA's partitioner; eager torch has none.  The port shards by
    running one process per shard, and the explicit collectives of
    sharded serving (:func:`gather_heads`, :func:`gather_rows`) and of
    the training mesh (:func:`copy_to_model`, :func:`reduce_from_model`,
    :func:`gather_from_model`, :func:`all_reduce_max`) stand where the
    reference's partitioner would place its own."""
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


# ---------------------------------------------------------------------------
# the training mesh (one process per shard, DESIGN.md §5)
# ---------------------------------------------------------------------------

# calls and bytes (this rank's tensors) of each training collective
COLLECTIVES = {k: {"calls": 0, "bytes": 0}
               for k in ("copy_to_model", "reduce_from_model",
                         "gather_from_model", "scatter_to_model", "absmax",
                         "partials",
                         "grads", "loss")}


class TrainShard:
    """This rank's place on the training mesh: ``dp`` and ``tp`` (the
    'data' and 'model' sizes), its coordinates ``data`` and ``model``, and
    the process groups of its 'data' and 'model' axes (None on a one-rank
    axis, except the 'data' group of a one-rank mesh: its step runs the
    mesh path's gradient and loss reduces over that group of one, each
    the identity)."""

    def __init__(self, dp: int, tp: int, data: int, model: int,
                 data_group=None, model_group=None):
        self.dp, self.tp = int(dp), int(tp)
        self.data, self.model = int(data), int(model)
        self.data_group = data_group if self.dp > 1 or self.tp == 1 else None
        self.model_group = model_group if self.tp > 1 else None

    def groups(self, *axes) -> tuple:
        """The groups of ``axes`` ('data', 'model') that split anything."""
        return tuple(g for g in (self.data_group if "data" in axes else None,
                                 self.model_group if "model" in axes
                                 else None) if g is not None)


_TRAIN_SHARD: list = []


def train_shard_of(mesh) -> TrainShard:
    """This rank's :class:`TrainShard` on ``mesh`` (a ('data', 'model')
    ``DeviceMesh``, or a (1, 1) ``MeshShape``)."""
    sizes = mesh_sizes(mesh)
    if set(sizes) - {"data", "model"}:
        raise NotImplementedError(
            f"the training mesh takes ('data', 'model') axes; got "
            f"{tuple(sizes)}")
    dp, tp = sizes.get("data", 1), sizes.get("model", 1)
    coord = mesh_coordinate(mesh)
    groups = {}
    if hasattr(mesh, "get_group"):
        for a in ("data", "model"):
            if sizes.get(a, 1) > 1 or dp == tp == 1:
                groups[a] = mesh.get_group(a)
    return TrainShard(dp, tp, coord.get("data", 0), coord.get("model", 0),
                      groups.get("data"), groups.get("model"))


@contextlib.contextmanager
def train_shard_scope(mesh):
    """Install ``mesh`` (a ('data', 'model') ``DeviceMesh``, or a (1, 1)
    ``MeshShape``) as the ambient mesh and this rank's :class:`TrainShard`
    for the model code of one training step (DESIGN.md §5).  Yields the
    shard."""
    shard = train_shard_of(mesh)
    _TRAIN_SHARD.append(shard)
    try:
        with mesh_context(mesh):
            yield shard
    finally:
        _TRAIN_SHARD.pop()


def train_shard() -> Optional[TrainShard]:
    """The active training shard, or None outside a training mesh."""
    return _TRAIN_SHARD[-1] if _TRAIN_SHARD else None


def _count(kind: str, t: torch.Tensor) -> None:
    COLLECTIVES[kind]["calls"] += 1
    COLLECTIVES[kind]["bytes"] += t.numel() * t.element_size()


def _sum_f32(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """All-reduce (sum) of ``x`` over ``group`` in f32 (gloo's CUDA path
    takes f32; a sum of two bf16 values rounds once either way), cast
    back to x's dtype.  A new tensor."""
    import torch.distributed as dist

    t = x.detach().to(torch.float32).clone()
    _count(kind, t)
    dist.all_reduce(t, group=group)
    return t.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.group, "copy_to_model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group, "reduce_from_model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x: torch.Tensor, group, dim: int,
            kind: str = "gather_from_model") -> torch.Tensor:
    import torch.distributed as dist

    n = dist.get_world_size(group)
    src = x.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _count(kind, out)
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, src, group=group)
    return out.movedim(0, dim)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, reduce_grad):
        import torch.distributed as dist

        ctx.group, ctx.dim, ctx.reduce_grad = group, dim, reduce_grad
        ctx.size, ctx.rank = x.shape[dim], dist.get_rank(group)
        return _gather(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            g = _sum_f32(g, ctx.group, "gather_from_model")
        return (g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size).contiguous(),
                None, None, None)


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        import torch.distributed as dist

        ctx.group, ctx.dim = group, dim
        size = x.shape[dim] // dist.get_world_size(group)
        return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_gather(g, ctx.group, ctx.dim, "scatter_to_model")
                .contiguous(), None, None)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; backward all-reduces the gradient over 'model'.
    Before a column-parallel product (each 'model' rank's part of x's
    gradient is partial), and around a replicated weight that each rank
    applies to its own token shard (the sequence split).  Identity
    outside a training mesh with tp > 1."""
    s = train_shard()
    if s is None or s.model_group is None:
        return x
    return _CopyToModel.apply(x, s.model_group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """All-reduce (sum, in f32) over 'model' forward; identity backward.
    After a row-parallel product's partial sums and the vocab-parallel
    embedding's masked rows."""
    s = train_shard()
    if s is None or s.model_group is None:
        return x
    return _ReduceFromModel.apply(x, s.model_group)


def gather_from_model(x: torch.Tensor, dim: int,
                      reduce_grad: bool = True) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over 'model' in coordinate order.
    Backward: the gradient all-reduced over 'model' and this rank's slice
    taken (``reduce_grad``: each rank used the gathered tensor for its own
    part of the work, as the sequence split's K and V), or only sliced
    (every rank continues with the same replicated computation, as the
    sequence split's output rows).  Not reduce-scatter: gloo has none."""
    s = train_shard()
    if s is None or s.model_group is None:
        return x
    return _GatherFromModel.apply(x, s.model_group, dim, reduce_grad)


def scatter_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This 'model' rank's block of ``x`` (replicated over 'model') along
    ``dim``, in coordinate order; backward all-gathers the gradient, so
    every rank continues with the whole gradient of ``x``.  Before a
    row-parallel product whose input every rank computed in full (the
    SSD's ``out_proj``): with a plain slice each rank's gradient of x
    would hold only its own block, and the replicated leaves that made x
    would update differently on each rank.  Identity outside a training
    mesh with tp > 1."""
    s = train_shard()
    if s is None or s.model_group is None:
        return x
    return _ScatterToModel.apply(x, s.model_group, dim)


def all_reduce_max(x: torch.Tensor, groups=()) -> torch.Tensor:
    """The maximum of ``x`` (a 0-dim absmax) over every group of
    ``groups``, in f32 and cast back (a bf16 value is exact in f32); no
    gradient (the policy's absmax is outside autograd in the reference
    too).  Identity with no groups."""
    import torch.distributed as dist

    if not groups:
        return x
    t = x.detach().to(torch.float32).clone()
    for g in groups:
        _count("absmax", t)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
    return t.to(x.dtype)


def all_reduce_sum(x: torch.Tensor, group, kind: str = "partials"
                   ) -> torch.Tensor:
    """Exact all-reduce (sum) of an integer tensor over ``group``, in
    place; returns it.  Kernel 6's K-block partials."""
    import torch.distributed as dist

    if group is not None:
        _count(kind, x)
        dist.all_reduce(x, group=group)
    return x


def all_reduce_mean(flat: torch.Tensor, group, n: int,
                    kind: str = "grads") -> torch.Tensor:
    """The mean of an f32 bucket over ``group`` of ``n`` ranks, in place
    (the data-parallel gradient reduce); returns it."""
    import torch.distributed as dist

    if group is not None:
        _count(kind, flat)
        dist.all_reduce(flat, group=group)
        flat /= n
    return flat
