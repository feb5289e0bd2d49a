"""Meshes (counterpart of the reference's ``launch/mesh.py``).  Functions,
not module constants: importing this file touches no process group.

A serve mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with axes
('data', 'model') over the running process group, one process per shard:
start the processes with ``torchrun --nproc-per-node N`` (each rank then
finds ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` in its environment) or
spawn them and call ``torch.distributed.init_process_group`` yourself.
NCCL serves when every rank has its own GPU, gloo on the CPU."""

from __future__ import annotations

import torch

from repro_torch.dist.sharding import MeshShape

__all__ = ["make_production_mesh", "make_local_mesh", "make_serve_mesh",
           "parse_serve_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's target topology as a shape: one pod = (data=16,
    model=16); multi-pod adds a leading 'pod' DP axis (2 × 16 × 16)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def _device_type(device) -> str:
    return torch.device(device).type


def make_local_mesh(*, device="cuda"):
    """The running process group as a (world size, 1) ('data', 'model')
    mesh; a process outside any process group is a (1, 1) shape."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return MeshShape(("data", "model"), (1, 1))
    return make_serve_mesh(dist.get_world_size(), 1, device=device)


def make_serve_mesh(data: int, model: int, *, device="cuda"):
    """A ('data', 'model') ``DeviceMesh`` over the running process group
    for the sharded serving engine (DESIGN.md §9): rank r sits at data
    coordinate r // model and model coordinate r % model.  A process
    outside any process group starts a one-process gloo group over a file
    store, enough for the (1, 1) mesh."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be positive; got ({data}, {model})")
    if not dist.is_initialized():
        if data * model != 1:
            raise ValueError(
                f"mesh ({data}, {model}) needs {data * model} processes, "
                "have 1 (no process group: launch with torchrun "
                f"--nproc-per-node {data * model})")
        path = tempfile.mkstemp(prefix="repro_torch_pg_")[1]
        dist.init_process_group(
            "nccl" if _device_type(device) == "cuda" else "gloo",
            init_method=f"file://{path}", world_size=1, rank=0)
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(
            f"mesh ({data}, {model}) needs {data * model} processes, have "
            f"{world} (launch with torchrun --nproc-per-node "
            f"{data * model})")
    ranks = torch.arange(world).reshape(data, model)
    return DeviceMesh(_device_type(device), ranks,
                      mesh_dim_names=("data", "model"))


def parse_serve_mesh(spec: str, *, device="cuda"):
    """Parse a CLI ``--mesh`` value ('DATA,MODEL', e.g. '2,2') into a serve
    mesh, with the reference's syntax and messages."""
    try:
        data, model = (int(x) for x in spec.split(","))
    except ValueError:
        raise ValueError(
            f"--mesh expects DATA,MODEL (e.g. '2,2'); got {spec!r}"
        ) from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh axes must be positive; got {spec!r}")
    return make_serve_mesh(data, model, device=device)
