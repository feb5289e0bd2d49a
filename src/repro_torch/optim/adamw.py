"""AdamW over the port's params trees (nested dicts and lists of
tensors): the counterpart of the reference's ``optim/adamw.py``.

Moments are stored in f32 regardless of param dtype (mixed-precision master
statistics).  ``apply_updates`` returns new tensors for the params and the
state, as the reference does, and writes nothing in place: the policy's
weight-absmax cache (``kernels/dither_matmul.weight_absmax``) is keyed on
a tensor's storage and ``_version``, and a write through ``.data`` would
not bump the version, so the cached range would go stale.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Union

import torch

from repro_torch import tree

__all__ = ["AdamW", "init_opt_state", "apply_updates"]


@dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        return self.lr(step) if callable(self.lr) else _f32(self.lr, step)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def init_opt_state(params: Any) -> Any:
    """f32 zeros shaped like every leaf, and a 0-d int32 step, on the
    params' device."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    device = tree.leaves(params)[0].device
    return {"m": tree.tree_map(zeros, params),
            "v": tree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _global_norm(grads: Any, norm_shard=None) -> torch.Tensor:
    """The gradients' global L2 norm.  ``norm_shard`` (training mesh):
    ``(sharded, group)``, per leaf whether it is this rank's block of a
    leaf split over 'model': those leaves' squares are summed over
    ``group`` (in f32), every replicated leaf counted once."""
    if norm_shard is None:
        total = 0
        for g in tree.leaves(grads):
            total = total + torch.sum(torch.square(g.to(torch.float32)))
        return torch.sqrt(total)
    sharded, group = norm_shard
    parts = [0, 0]
    for g, s in zip(tree.leaves(grads), sharded):
        parts[s] = parts[s] + torch.sum(torch.square(g.to(torch.float32)))
    split = torch.as_tensor(parts[1], dtype=torch.float32,
                            device=tree.leaves(grads)[0].device)
    if group is not None:
        import torch.distributed as dist

        split = split.clone()
        dist.all_reduce(split, group=group)
    return torch.sqrt(parts[0] + split)


# leaves of more elements than this update in blocks of leading rows
CHUNK_ELEMENTS = 1 << 26


def _rows_a_chunk(p: torch.Tensor):
    """Rows of ``p`` a block of its update, or None to update it whole."""
    if p.numel() <= CHUNK_ELEMENTS or p.dim() == 0 or p.shape[0] < 2:
        return None
    return max(1, CHUNK_ELEMENTS // (p.numel() // p.shape[0]))


def apply_updates(opt: AdamW, params: Any, grads: Any, state: Any,
                  norm_shard=None):
    """One AdamW step → (new_params, new_state, metrics).  ``norm_shard``:
    the training mesh's layout for the global norm (``_global_norm``)."""
    step = state["step"] + 1
    gnorm = _global_norm(grads, norm_shard)
    # tensor / tensor: a Python number over a tensor is a reciprocal product
    scale = (torch.clamp_max(_f32(opt.grad_clip, step) / (gnorm + 1e-9), 1.0)
             if opt.grad_clip else 1.0)

    b1, b2 = opt.b1, opt.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(b1, step), stepf)
    bc2 = 1.0 - torch.pow(_f32(b2, step), stepf)
    lr = opt.lr_at(step)

    def upd_rows(p, g, m, v, decay):
        g = g.to(torch.float32) * scale
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
        mh = m_new / bc1
        vh = v_new / bc2
        delta = mh / (torch.sqrt(vh) + opt.eps)
        if decay:
            delta = delta + opt.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m_new, v_new

    def upd(p, g, m, v):
        decay = bool(opt.weight_decay) and p.dim() >= 2  # matrices only
        rows = _rows_a_chunk(p)
        if rows is None:
            return upd_rows(p, g, m, v, decay)
        # a large leaf in blocks of rows (elementwise: the same bits), so
        # its f32 temporaries stay small beside the new state
        outs = (torch.empty_like(p), torch.empty_like(m),
                torch.empty_like(v))
        for r0 in range(0, p.shape[0], rows):
            sl = slice(r0, r0 + rows)
            for out, part in zip(outs, upd_rows(p[sl], g[sl], m[sl], v[sl],
                                                decay)):
                out[sl] = part
        return outs

    flat_p = tree.leaves(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, tree.leaves(grads), tree.leaves(state["m"]),
        tree.leaves(state["v"]))]
    new_p = tree.unflatten(params, [o[0] for o in out])
    new_m = tree.unflatten(params, [o[1] for o in out])
    new_v = tree.unflatten(params, [o[2] for o in out])
    return (new_p, {"m": new_m, "v": new_v, "step": step},
            {"grad_norm": gnorm, "lr": lr})
