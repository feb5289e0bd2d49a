"""Training step: loss, grads, optimizer, numerics policy, microbatching —
the port's counterpart of the reference's ``train/trainer.py``.

``make_train_step`` builds the step the launcher runs:  state = {params,
opt, counter} → state', metrics.  The dither counter i_s advances once per
step — "rounding in time" (§VII).  The step is eager PyTorch (no
``torch.compile``): autograd through ``registry.apply_model``, where the
reference takes ``jax.value_and_grad`` of a jitted function.

On a training mesh (``mesh=``, a ('data', 'model') ``DeviceMesh`` with one
process per rank, DESIGN.md §5) every rank runs the same step on its data
shard's rows and its blocks of params, m and v
(``init_train_state(mesh=, coords=)``): the model runs Megatron TP under
``dist.ctx.train_shard_scope``, the loss is taken over vocab-sharded
logits, the gradients are averaged over 'data' as one flat f32 bucket,
compressed after that reduce (as the reference compresses the reduced
gradient), and AdamW's global norm sums each sharded leaf over 'model'.
A (1, 1) mesh runs this path too, its reduces over a group of one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import tree
from repro_torch.dist import ctx
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.numerics.policy import QuantPolicy
from repro_torch.optim import adamw, grad_compress

__all__ = ["init_train_state", "make_train_step", "loss_fn",
           "loss_and_grads"]


def loss_fn(params, cfg: ModelConfig, batch, policy, counter, remat=True):
    """Next-token cross entropy over the token region (frontend tokens
    skipped).  Logits stay vocab-padded: the pad columns are masked to
    -1e30 before the f32 log-softmax."""
    logits = registry.apply_model(params, cfg, batch, policy=policy,
                                  counter=counter, remat=remat)
    tokens = batch["tokens"]
    n_front = logits.shape[1] - tokens.shape[1]
    logits = logits[:, n_front:, :]
    vp = logits.shape[-1]
    sh = ctx.train_shard()
    if sh is not None and sh.tp > 1 and vp != cfg.vocab_padded():
        return _sharded_loss(logits, batch["labels"], cfg, sh)
    if vp != cfg.vocab_size:  # mask vocab padding out of the softmax
        pad_mask = torch.arange(vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(pad_mask[None, None, :], logits, -1e30)
    labels = batch["labels"]
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels[:, 1:, None].long())[..., 0]
    return -torch.mean(ll)


def _sharded_loss(logits, labels, cfg: ModelConfig, sh):
    """``loss_fn``'s cross entropy over this 'model' rank's vocab columns
    (B, S, V_pad / tp): the pad columns masked as there, then the row
    max (all-reduced, max, outside autograd as a shift), the sum of exps
    and the label's logit (the one rank that holds it) each summed over
    'model' by ``reduce_from_model``."""
    v_l = logits.shape[-1]
    v0 = sh.model * v_l
    cols = torch.arange(v_l, device=logits.device) + v0
    logits = torch.where((cols < cfg.vocab_size)[None, None, :], logits,
                         -1e30)[:, :-1].to(torch.float32)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    if sh.model_group is not None:
        import torch.distributed as dist

        m = m.clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=sh.model_group)
    shifted = logits - m
    sumexp = ctx.reduce_from_model(torch.sum(torch.exp(shifted), dim=-1))
    lab = labels[:, 1:].long() - v0
    inside = (lab >= 0) & (lab < v_l)
    picked = torch.gather(shifted, -1, lab.clamp(0, v_l - 1)[..., None])[..., 0]
    picked = ctx.reduce_from_model(torch.where(inside, picked, 0.0))
    return -torch.mean(picked - torch.log(sumexp))


def init_train_state(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                     mesh=None, coords: Optional[dict] = None
                     ) -> Dict[str, Any]:
    """Random params from ``seed`` (``registry.init_model``), zero AdamW
    moments and a 0-d int32 counter, on ``device``.

    ``mesh`` and ``coords`` (axis name → this rank's coordinate): the
    rank's local state on the training mesh, ``interop.shard_train_state``
    of the global state bit for bit, without ever holding the global
    moments: the seeded global params are cut to the rank's blocks
    (``interop.shard_train_params``) and the moments made at the local
    shapes.  (recurrentgemma-9b's global f32 moments alone take 20 GB at
    3 of its 38 layers, on every rank.)"""
    params = registry.init_model(cfg, seed=seed, device=device)
    if mesh is not None:
        from repro_torch import interop

        params = interop.shard_train_params(params, cfg, coords, mesh)
    return {"params": params,
            "opt": adamw.init_opt_state(params),
            "counter": torch.zeros((), dtype=torch.int32, device=device)}


def loss_and_grads(params, cfg: ModelConfig, batch, policy, counter,
                   remat: bool = True):
    """(loss, grads in the params' dtypes): ``jax.value_and_grad(loss_fn)``
    by autograd on detached leaves, so the caller's params never carry
    autograd state."""
    flat = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss = loss_fn(tree.unflatten(params, flat), cfg, batch, policy,
                   counter, remat)
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), tree.unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, opt: adamw.AdamW,
                    policy: Optional[QuantPolicy] = None,
                    grad_policy: Optional[QuantPolicy] = None,
                    microbatch: int = 0, remat: bool = True, mesh=None):
    """Build train_step(state, batch) → (state, metrics).

    ``microbatch`` > 1 splits the batch into that many chunks (chunk i takes
    rows i, i + microbatch, …, as the reference's batch-major reshape and
    swap) run one after another, accumulating f32 grads.

    Policies are resolved here (``QuantPolicy.resolved``): a backend name
    is checked once, at build time; ``"auto"`` stays and each product
    picks the CUDA kernel or its plain version by its operands' device.
    The counter is read from the state once per step and passed to every
    product as a number.

    ``mesh``: train on a ('data', 'model') mesh (module docstring); the
    step then takes this rank's local state and its data shard's rows of
    the global batch (rows ``[r·B/dp, (r+1)·B/dp)``; with microbatches,
    B/dp divisible by their count, so that a rank's chunk i is the
    reference's microbatch i restricted to its shard).  Gradient
    compression's per-leaf seeds are rank 0's, broadcast here, since
    Python salts ``hash()`` per process.
    """
    policy = policy.resolved() if policy is not None else None
    grad_policy = grad_policy.resolved() if grad_policy is not None else None
    sh = None if mesh is None else ctx.train_shard_of(mesh)
    layout = {}

    def local_layout(params):
        """Per leaf (flatten order): sharded on 'model'?, its ShardView
        and, under gradient compression, rank 0's seed — once, at the
        first step (the broadcast is a collective every rank reaches)."""
        if "views" not in layout:
            from repro_torch import interop
            from repro_torch.dist import sharding

            sizes = ctx.mesh_sizes(mesh)
            coords = {"data": sh.data, "model": sh.model}
            shapes = interop.global_shapes(params, cfg, mesh)
            specs = sharding.spec_leaves(
                sharding.train_param_specs(shapes, cfg, mesh))
            # split over 'model' only where that axis has more than one
            # rank: at tp 1 every leaf is whole, and the norm sums in the
            # single-device order
            layout["sharded"] = [sh.tp > 1 and "model" in sp for sp in specs]
            layout["views"] = [
                sharding.shard_view(g.shape, sp, sizes, coords)
                for g, sp in zip(tree.leaves(shapes), specs)]
            if grad_policy is not None and grad_policy.enabled:
                import torch.distributed as dist

                box = [grad_compress.leaf_seeds(params)]
                dist.broadcast_object_list(box, src=0)
                layout["seeds"] = box[0]
        return layout

    def reduce_grads(grads):
        """The mean over 'data' of every gradient, as one flat f32
        bucket."""
        if sh.data_group is None:
            return grads
        flat_g = tree.leaves(grads)
        bucket = torch.cat([g.to(torch.float32).reshape(-1) for g in flat_g])
        ctx.all_reduce_mean(bucket, sh.data_group, sh.dp)
        # each leaf back in its gradient's own strides (autograd hands
        # some out transposed): a sum over another layout adds in another
        # order, and the global norm moved by an ulp
        out = [torch.empty_like(g).copy_(part.view(g.shape))
               for part, g in zip(bucket.split([g.numel() for g in flat_g]),
                                  flat_g)]
        return tree.unflatten(grads, out)

    def step(state, batch):
        if sh is None:
            return local_step(state, batch)
        if microbatch and microbatch > 1 \
                and batch["tokens"].shape[0] % microbatch:
            raise ValueError(
                f"a data shard's {batch['tokens'].shape[0]} rows do not "
                f"split into {microbatch} microbatches")
        with ctx.train_shard_scope(mesh):
            return local_step(state, batch)

    def local_step(state, batch):
        params = state["params"]
        counter = int(state["counter"])
        if microbatch and microbatch > 1:
            loss = torch.zeros((), dtype=torch.float32,
                               device=state["counter"].device)
            grads = tree.tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            for i in range(microbatch):
                mb = {k: v[i::microbatch] for k, v in batch.items()}
                l_i, g_i = loss_and_grads(params, cfg, mb, policy, counter,
                                           remat)
                loss = loss + l_i
                grads = tree.tree_map(torch.add, grads, g_i)
            loss = loss / microbatch
            grads = tree.tree_map(lambda g: g / microbatch, grads)
        else:
            loss, grads = loss_and_grads(params, cfg, batch, policy,
                                          counter, remat)

        norm_shard = None
        lay = None
        if sh is not None:
            grads = reduce_grads(grads)
            if sh.data_group is not None:
                loss = ctx.all_reduce_mean(loss.reshape(1).clone(),
                                           sh.data_group, sh.dp, "loss")[0]
            lay = local_layout(params)
            norm_shard = (lay["sharded"], sh.model_group)
        if grad_policy is not None and grad_policy.enabled:
            grads = grad_compress.compress_grads(
                grads, grad_policy, counter,
                views=None if lay is None else lay["views"],
                groups=None if lay is None else [
                    sh.groups("model") if s else () for s in lay["sharded"]],
                seeds=None if lay is None else lay["seeds"])

        new_params, new_opt, om = adamw.apply_updates(
            opt, params, grads, state["opt"], norm_shard=norm_shard)
        return ({"params": new_params, "opt": new_opt,
                 "counter": state["counter"] + 1},
                {"loss": loss, **om})

    return step
