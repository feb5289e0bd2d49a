"""Training step: loss, grads, optimizer, numerics policy, microbatching —
the port's counterpart of the reference's ``train/trainer.py``.

``make_train_step`` builds the step the launcher runs:  state = {params,
opt, counter} → state', metrics.  The dither counter i_s advances once per
step — "rounding in time" (§VII).  The step is eager PyTorch (no
``torch.compile``): autograd through ``registry.apply_model``, where the
reference takes ``jax.value_and_grad`` of a jitted function.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import tree
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
    if vp != cfg.vocab_size:  # mask vocab padding out of the softmax
        pad_mask = torch.arange(vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(pad_mask[None, None, :], logits, -1e30)
    labels = batch["labels"]
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels[:, 1:, None].long())[..., 0]
    return -torch.mean(ll)


def init_train_state(cfg: ModelConfig, *, seed: int = 0,
                     device="cuda") -> Dict[str, Any]:
    """Random params from ``seed`` (``registry.init_model``), zero AdamW
    moments and a 0-d int32 counter, on ``device``."""
    params = registry.init_model(cfg, seed=seed, device=device)
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
                    microbatch: int = 0, remat: bool = True):
    """Build train_step(state, batch) → (state, metrics).

    ``microbatch`` > 1 splits the batch into that many chunks (chunk i takes
    rows i, i + microbatch, …, as the reference's batch-major reshape and
    swap) run one after another, accumulating f32 grads.

    Policies are resolved here (``QuantPolicy.resolved``): a backend name
    is checked once, at build time; ``"auto"`` stays and each product
    picks the CUDA kernel or its plain version by its operands' device.
    The counter is read from the state once per step and passed to every
    product as a number.
    """
    policy = policy.resolved() if policy is not None else None
    grad_policy = grad_policy.resolved() if grad_policy is not None else None

    def step(state, batch):
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

        if grad_policy is not None and grad_policy.enabled:
            grads = grad_compress.compress_grads(grads, grad_policy, counter)

        new_params, new_opt, om = adamw.apply_updates(opt, params, grads,
                                                      state["opt"])
        return ({"params": new_params, "opt": new_opt,
                 "counter": state["counter"] + 1},
                {"loss": loss, **om})

    return step
