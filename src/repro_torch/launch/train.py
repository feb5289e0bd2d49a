"""Training launcher of the port: an end-to-end training loop with
checkpoint and restart, on the card (or, with ``--device cpu``, on the
CPU):

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \\
      --steps 50 --batch 8 --seq 512 --policy dither --kernel-backend auto \\
      --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \\
      --reduced --device cpu --steps 4 --batch 2 --seq 16 --policy dither \\
      --kernel-backend torch-ref
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite_moe_1b_a400m --reduced --device cpu --steps 4 \\
      --batch 2 --seq 16       # or internvl2_1b: its stub embeds prepended
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_370m \\
      --reduced --device cpu --steps 4 --batch 2 --seq 16
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper_small \\
      --reduced --device cpu --steps 4 --batch 2 --seq 16

``--arch`` takes every id of ``repro_torch.configs.ARCH_IDS``; a
``vit_stub`` config trains on the pipeline's ``embeds`` beside its tokens,
the encoder-decoder on its ``frames`` (the audio stub's hashed frames).
Takes the reference launcher's flags, plus ``--device``.  Under
``torchrun`` it trains data-parallel on ``launch/mesh.make_local_mesh``
(the world size × 1 ('data', 'model') mesh, as the reference's launcher
does), each rank on ``cuda:$LOCAL_RANK`` (NCCL) or the CPU (gloo), every
rank taking its rows of the same global batch; only rank 0 prints::

  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --arch smollm_135m --reduced \
      --device cpu --steps 4 --batch 4 --seq 16

``run_training(mesh=...)`` takes any ('data', 'model') mesh (tensor
parallel too, DESIGN.md §5).  Weights
are random, drawn from ``--seed``'s generator (the reference draws its own
from ``PRNGKey(seed)``, so the values differ).
"""

from __future__ import annotations

import argparse
import os
import time

from repro_torch import interop
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.dist.fault_tolerance import (FailureInjector,
                                              StragglerWatchdog)
from repro_torch.kernels import dispatch
from repro_torch.numerics.policy import QuantPolicy
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import cosine_schedule, wsd_schedule
from repro_torch.train import trainer

__all__ = ["train_main", "run_training"]


def run_training(
    cfg,
    *,
    steps: int,
    batch: int,
    seq: int,
    policy=None,
    grad_policy=None,
    ckpt_dir=None,
    ckpt_every: int = 20,
    seed: int = 0,
    schedule: str = "cosine",
    peak_lr: float = 3e-4,
    injector: FailureInjector | None = None,
    log=print,
    device="cuda",
    mesh=None,
):
    """One training run on ``device``; resumes from the latest checkpoint
    if present.  Returns (final step, losses).  A crash leaves the loop
    only after the checkpoint writer has finished, so a restarted run reads
    a settled directory.

    In a process group (``torchrun``, or ranks started by the caller) the
    run is one rank of a ('data', 'model') training mesh: ``mesh``, by
    default ``make_local_mesh`` (world size × 1).  Each rank builds its
    blocks of the same seeded state (``trainer.init_train_state`` with
    ``mesh=``), takes rows ``[r·B/dp, (r+1)·B/dp)``
    of every global batch, checkpoints the gathered global state (rank
    (0, 0) writes) and restores onto its own mesh shape, whatever mesh
    wrote the checkpoint."""
    import torch.distributed as dist

    from repro_torch.dist import ctx
    from repro_torch.launch.mesh import make_local_mesh

    if mesh is None and dist.is_initialized():
        mesh = make_local_mesh(device=device)
    shard = ctx.train_shard_of(mesh) if mesh is not None else None
    if shard is not None and batch % shard.dp:
        raise ValueError(f"batch {batch} does not split over {shard.dp} "
                         "data shards")
    lr = (wsd_schedule(peak_lr, 10, steps // 2, steps // 2)
          if schedule == "wsd" else cosine_schedule(peak_lr, 10, steps))
    opt = AdamW(lr=lr)
    step_fn = trainer.make_train_step(cfg, opt, policy=policy,
                                      grad_policy=grad_policy, mesh=mesh)
    coords = {"data": 0, "model": 0}
    if shard is not None:
        coords = {"data": shard.data, "model": shard.model}
    state = trainer.init_train_state(cfg, seed=seed, device=device,
                                     mesh=None if shard is None else mesh,
                                     coords=coords)

    ck = Checkpointer(ckpt_dir, mesh=mesh, cfg=cfg) if ckpt_dir else None
    start = 0
    if ck is not None:
        latest = ck.latest_step()
        if latest is not None:
            places = (interop.train_state_shardings(state, cfg, mesh, coords)
                      if shard is not None else None)
            state = ck.restore(latest, state, places)
            start = latest
            log(f"resumed from step {start}")
    rows = (slice(None) if shard is None else
            slice(shard.data * batch // shard.dp,
                  (shard.data + 1) * batch // shard.dp))

    dcfg = DataConfig(batch=batch, seq=seq, seed=seed)
    watchdog = StragglerWatchdog()
    losses = []
    try:
        for step in range(start, steps):
            t0 = time.time()
            data = {k: v[rows] for k, v in synthetic_batch(
                cfg, dcfg, step, device=device).items()}
            if injector:
                injector.maybe_fail(step, "before_save")
            state, metrics = step_fn(state, data)
            losses.append(float(metrics["loss"]))
            dt = time.time() - t0
            if watchdog.observe(step, dt):
                log(f"straggler flagged at step {step} ({dt:.2f}s)")
            if ck is not None and (step + 1) % ckpt_every == 0:
                ck.save_async(step + 1, state)
                if injector:
                    injector.maybe_fail(step, "after_save")
            if step % 10 == 0:
                log(f"step {step:5d} loss {losses[-1]:.4f} "
                    f"({dt * 1e3:.0f} ms)")
    finally:
        if ck is not None:
            ck.wait()
    if ck is not None:
        ck.save(steps, state)
    return steps, losses


def train_main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--policy", default="none",
                    choices=["none", "dither", "stochastic", "deterministic"])
    ap.add_argument("--policy-bits", type=int, default=8)
    ap.add_argument("--kernel-backend", default=dispatch.UNFUSED,
                    help="policy matmul backend: 'torch' (unfused fake-quant, "
                         "the reference's 'jnp') or a kernel-dispatch backend "
                         "(auto, cuda, torch-ref)")
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "dither", "stochastic"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    device, rank0 = args.device, True
    if "RANK" in os.environ:
        import torch
        import torch.distributed as dist

        if not dist.is_initialized():
            if torch.device(device).type == "cuda":
                device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
                torch.cuda.set_device(device)
            dist.init_process_group("nccl" if device.startswith("cuda")
                                    else "gloo")
        rank0 = dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    policy = (None if args.policy == "none"
              else QuantPolicy(scheme=args.policy, bits=args.policy_bits,
                               backend=args.kernel_backend))
    gpolicy = (None if args.grad_compress == "none"
               else QuantPolicy(scheme=args.grad_compress, bits=8))
    steps, losses = run_training(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        policy=policy, grad_policy=gpolicy, ckpt_dir=args.ckpt_dir,
        schedule=args.schedule, peak_lr=args.lr, device=device, log=say,
    )
    say(f"done: {steps} steps; loss {losses[0]:.4f} -> {losses[-1]:.4f}")


if __name__ == "__main__":
    train_main()
