"""Atomic, async-capable checkpointing in plain numpy: the port's
counterpart of the reference's ``checkpoint/checkpointer.py``, on the same
layout, so one checkpoint reads in both packages.

Layout:  <dir>/step_<N>/arrays.npz + manifest.json, written to a tmp dir and
atomically renamed so a crash mid-save never corrupts the latest checkpoint.
Leaves are stored as ``leaf_<i>`` in JAX's ``tree_flatten`` order (dict keys
sorted, lists in order, 0-d tensors such as ``step`` and ``counter`` as
0-d arrays); bf16 tensors are widened to f32 and cast back on restore.
``save_async`` copies the tensors to the host in the caller's thread and
writes on a writer thread (the train loop keeps stepping).  Restore places
each leaf on the device, and in the dtype, of the matching leaf of
``like``.

On the training mesh (``Checkpointer(dir, mesh=..., cfg=...)``, DESIGN.md
§5) a checkpoint holds the global state: ``save`` gathers it
(``interop.gather_train_state``) on the calling thread — collectives
never run from the writer thread, whose timing differs between ranks —
rank (0, 0) writes, and every rank meets at ``ctx.barrier()`` once the
file is settled.  ``restore(step, like, shardings)`` cuts each global
leaf to a mesh's layout (``interop.train_state_shardings``), so a run
restarts on another mesh shape (the reference's elastic restore).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree

__all__ = ["Checkpointer"]


def _host(x) -> np.ndarray:
    """One leaf as a numpy array; bf16 widened to f32 for npz portability."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.cpu().numpy()
    return np.asarray(x)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, mesh=None, cfg=None):
        self.dir = directory
        self.keep = keep
        self.mesh, self.cfg = mesh, cfg
        self._sharded = mesh is not None and hasattr(mesh, "get_group") \
            and mesh.size() > 1
        self._writer = (not self._sharded
                        or all(c == 0 for c in mesh.get_coordinate()))
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._pending = False

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, blocking: bool = True):
        """Write ``state`` (on a mesh: every rank's local train state,
        gathered to the global one first; every rank calls this)."""
        self.wait()  # one outstanding async save at a time
        if self._sharded:
            from repro_torch.interop import gather_train_state

            state = gather_train_state(state, self.cfg, self.mesh)
        if self._writer:
            host_leaves = [_host(x) for x in tree.leaves(state)]
            if blocking:
                self._write(step, host_leaves)
            else:
                self._thread = threading.Thread(
                    target=self._write, args=(step, host_leaves),
                    daemon=True)
                self._thread.start()
        self._pending = True
        if blocking:
            self.wait()

    def save_async(self, step: int, state: Any):
        self.save(step, state, blocking=False)

    def wait(self):
        """Join the writer; on a mesh every rank then meets at the
        barrier, so no rank reads the directory before the file is
        settled."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending and self._sharded:
            from repro_torch.dist.ctx import barrier

            barrier()
        self._pending = False

    def _write(self, step: int, host_leaves):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + f".tmp.{os.getpid()}.{int(time.time() * 1e6)}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(host_leaves),
                       "time": time.time()}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and "tmp" not in name:
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """Restore into the structure of ``like``: each leaf as a tensor on
        the device, and in the dtype, of ``like``'s leaf.  ``shardings``:
        a tree of ``dist.sharding.Placement`` matching ``like`` (for a
        train state, ``interop.train_state_shardings``): each global leaf
        cut to that rank's block of the mesh's layout, whatever mesh wrote
        it."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        ref_leaves = tree.leaves(like)
        places = (tree.leaves(shardings) if shardings is not None
                  else [None] * len(ref_leaves))
        if manifest["n_leaves"] != len(ref_leaves):
            raise ValueError(
                f"checkpoint/model mismatch: step {step} holds "
                f"{manifest['n_leaves']} leaves, the structure "
                f"{len(ref_leaves)}")
        restored = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for i, (ref, place) in enumerate(zip(ref_leaves, places)):
                x = torch.from_numpy(np.array(data[f"leaf_{i}"]))
                if place is not None:
                    x = place.local(x)
                if isinstance(ref, torch.Tensor):
                    x = x.to(device=ref.device, dtype=ref.dtype)
                restored.append(x)
        return tree.unflatten(like, restored)

    def restore_latest(self, like: Any, shardings: Any = None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like, shardings)
