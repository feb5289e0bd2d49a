"""Serving launcher of the port: drive the engine over a synthetic request
mix on the card (or, with ``--device cpu``, on the CPU), over the ring or
the paged KV cache:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_135m \\
      --requests 6 --batch 4 --max-new 8 --temperature 0.8 --top-k 40 \\
      --sched priority
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_135m \\
      --kv-layout paged --num-blocks 8 --kv-quant
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_135m \\
      --reduced --device cpu --spec-decode --draft-k 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_135m \\
      --policy dither --kernel-backend auto
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_135m \\
      --decode-ticks 8 --prefill-chunk 128 --kv-quant
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_135m \\
      --reduced --device cpu --kv-layout paged --max-len 32 --block-size 8 \\
      --metrics stdout --trace mem --snapshot-path /tmp/snap.json \\
      --deadline-ms 60000          # then again with --resume
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite_moe_1b_a400m --reduced --device cpu --kv-quant
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch mamba2_370m --reduced --device cpu --decode-ticks 4
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch whisper_small --reduced --device cpu --decode-ticks 4
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
      --mesh 2,2 --arch smollm_135m --reduced --device cpu --kv-quant

``--arch`` takes every id of ``repro_torch.configs.ARCH_IDS`` (the VLM is
served on tokens alone, as the reference's engine serves it; the
recurrent ``mamba2_370m`` and ``recurrentgemma_9b`` serve on the ring
only, prefilled by the scanned prefill, a captured CUDA graph a prompt
position on the card; the encoder-decoder ``whisper_small`` serves on
zero frames, as the reference's launcher serves it, its ``--kv-quant``
forced off as there: its self-KV is bf16).
Takes the reference launcher's flags, plus ``--device``.  ``--mesh
DATA,MODEL`` serves sharded (DESIGN.md §9), one process per shard under
``torchrun --nproc-per-node DATA·MODEL`` (``python -m
torch.distributed.run``): each rank serves on ``cuda:$LOCAL_RANK`` over
NCCL, or with ``--device cpu`` over gloo, and only rank 0 prints.
Weights are random, drawn from seed 0 (the reference draws its own from
``PRNGKey(0)``, so the values differ).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import registry
from repro_torch.numerics.policy import QuantPolicy
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.trace import format_explain


def serve_main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=5)
    ap.add_argument("--policy", default="none",
                    choices=["none", "dither", "stochastic", "deterministic"])
    ap.add_argument("--kernel-backend", default="torch",
                    help="policy matmul backend: 'torch' (unfused fake-quant, "
                         "the reference's 'jnp') or a kernel-dispatch backend "
                         "(auto, cuda, torch-ref)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="dither-quantised int8 KV cache")
    ap.add_argument("--kv-layout", default="ring", choices=["ring", "paged"],
                    help="KV cache layout: dense per-slot ring, or the paged "
                         "block pool with prefix caching + continuous "
                         "batching")
    ap.add_argument("--block-size", type=int, default=None,
                    help="paged pool block size in tokens (default: the "
                         "kernel autotuner's pick, a cached sweep winner "
                         "from $REPRO_AUTOTUNE_CACHE or else the largest of "
                         "8/16/32/64 giving a full-length request 4 blocks; "
                         "the CUDA kernel takes 1..64)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="paged pool capacity in blocks (default: matches "
                         "the dense ring, batch × ceil(max_len/bs))")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable cross-request prefix-block reuse")
    ap.add_argument("--decode-ticks", type=int, default=1,
                    help="decode ticks per window, drained by the host once "
                         "(DESIGN.md §11); on the card without a policy a "
                         "window is one CUDA-graph replay")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="piggyback chunked prefill: admit prompts in chunks "
                         "of this many tokens between decode windows "
                         "(paged: rounded to a block multiple; default: "
                         "whole-prompt prefill)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative draft-and-verify decode (DESIGN.md "
                         "§14): prompt-lookup drafting + one multi-token "
                         "verify call per window; the emitted stream stays "
                         "bitwise the plain-decode stream")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="speculative window width: 1 pending token + "
                         "draft-k - 1 drafted tokens per verify call")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="serve sharded on a (data, model) mesh, e.g. '2,2' "
                         "(DESIGN.md §9): one process per shard, started by "
                         "torchrun --nproc-per-node DATA*MODEL")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 = softmax sampling")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0,
                    help="base sampling seed (request r uses seed + r)")
    ap.add_argument("--sched", default="fcfs", choices=["fcfs", "priority"],
                    help="admission policy ('priority' favours high "
                         "Request.priority; the demo gives odd rids +1)")
    ap.add_argument("--metrics", default=None, metavar="SINK",
                    help="stream per-window engine metrics (DESIGN.md §10): "
                         "'stdout', or 'jsonl:<path>' / a *.jsonl path.  "
                         "Unset = collect but don't stream; the summary "
                         "prints either way")
    ap.add_argument("--trace", default=None, metavar="SPEC",
                    help="per-request span tracing (DESIGN.md §13): 'mem' "
                         "(in memory, enables the end-of-run attribution "
                         "lines), 'perfetto:<path>' (Chrome-trace JSON for "
                         "ui.perfetto.dev), 'jsonl:<path>' (streaming event "
                         "feed), comma-combinable.  Unset = off")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline from submission (DESIGN.md "
                         "§12): queued or running, a request past it "
                         "finishes with reason 'deadline'")
    ap.add_argument("--queue-cap", type=int, default=None,
                    help="bounded admission queue: submissions past this "
                         "depth shed per --shed-policy (DESIGN.md §12)")
    ap.add_argument("--shed-policy", default="reject-new",
                    choices=["reject-new", "evict-lowest-priority"],
                    help="what a full queue sheds: the newcomer, or the "
                         "lowest-priority queued request when the newcomer "
                         "outranks it")
    ap.add_argument("--snapshot-path", default=None, metavar="PATH",
                    help="persist an atomic engine snapshot every window "
                         "(JSON; DESIGN.md §12) — the crash-recovery point")
    ap.add_argument("--resume", action="store_true",
                    help="restore from --snapshot-path if it exists and "
                         "continue (bit for bit for policy-free serving) "
                         "instead of submitting the synthetic workload")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    policy = (None if args.policy == "none"
              else QuantPolicy(scheme=args.policy, backend=args.kernel_backend))
    mesh, rank0, device, started = None, True, args.device, False
    if args.mesh:
        import torch.distributed as dist

        from repro_torch.launch.mesh import parse_serve_mesh
        if "RANK" in os.environ and not dist.is_initialized():
            if torch.device(device).type == "cuda":
                device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
                torch.cuda.set_device(device)
            dist.init_process_group("nccl" if device.startswith("cuda")
                                    else "gloo")
            started = True
        try:
            mesh = parse_serve_mesh(args.mesh, device=device)
        except ValueError as e:
            ap.error(str(e))
        rank0 = dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    params = registry.init_model(cfg, seed=0, device=device)
    frames = (torch.zeros((args.batch, cfg.n_enc_tokens, cfg.d_model),
                          dtype=torch.bfloat16, device=device)
              if cfg.is_encdec else None)
    engine = Engine(params, cfg, args.batch, args.max_len, policy=policy,
                    frames=frames,
                    kv_quant=args.kv_quant and not cfg.is_encdec,
                    scheduler=args.sched,
                    kv_layout=args.kv_layout, device=device,
                    block_size=args.block_size, num_blocks=args.num_blocks,
                    prefix_cache=not args.no_prefix_cache, mesh=mesh,
                    decode_ticks=args.decode_ticks,
                    prefill_chunk=args.prefill_chunk,
                    # the other ranks' host state is rank 0's: they stream
                    # and trace nothing
                    metrics=args.metrics if rank0 else None,
                    trace=args.trace if rank0 else None,
                    queue_cap=args.queue_cap, shed_policy=args.shed_policy,
                    snapshot_path=args.snapshot_path,
                    spec_decode=args.spec_decode, draft_k=args.draft_k)
    resumed = False
    if args.resume and args.snapshot_path and \
            os.path.exists(args.snapshot_path):
        with open(args.snapshot_path) as fh:
            engine.restore(json.load(fh))
        resumed = True
        say(f"resumed from {args.snapshot_path} at tick {engine.tick} "
              f"({len(engine.finished)} finished, "
              f"{len(engine.scheduler)} queued)")
    if not resumed:
        for r in range(args.requests):
            prompt = [(7 * r + i) % (cfg.vocab_size - 1) + 1
                      for i in range(args.prompt_len)]
            engine.submit(Request(
                rid=r, prompt=prompt, priority=r % 2,
                deadline_s=(args.deadline_ms / 1e3
                            if args.deadline_ms is not None else None),
                sampling=SamplingParams(temperature=args.temperature,
                                        top_k=args.top_k, seed=args.seed + r,
                                        max_new=args.max_new,
                                        counter_offset=1000 * r)))
    t0 = time.time()
    done = engine.run(ticks=args.requests * (args.max_new + 6) + 20)
    dt = time.time() - t0
    for r in sorted(done, key=lambda x: x.rid):
        ttft = f"{1e3 * r.ttft:.0f}ms" if r.ttft is not None else "-"
        say(f"req {r.rid} [{r.finish_reason}] ttft={ttft}: {r.out}")
    st = engine.stats
    pf = st["prefill_tokens"] / st["prefill_s"] if st["prefill_s"] else 0.0
    dc = st["decode_tokens"] / st["decode_s"] if st["decode_s"] else 0.0
    say(f"served {len(done)}/{args.requests} requests in {dt:.2f}s on "
          f"{device} (prefill {pf:.0f} tok/s over "
          f"{st['prefill_calls']} calls, decode {dc:.0f} tok/s over "
          f"{st['decode_calls']} decode windows)")
    if args.kv_layout == "paged":
        ps = engine.pool_stats()
        say(f"paged pool: block_size={engine.block_size} "
              f"num_blocks={engine.num_blocks} "
              f"prefix_hit_tokens={st['prefix_hit_tokens']} "
              f"preemptions={st['preemptions']} "
              f"cow_copies={ps['cow_copies']} live_blocks={ps['live']}")
    if args.spec_decode:
        drafted, acc = st["spec_draft_tokens"], st["spec_accepted_tokens"]
        rate = acc / drafted if drafted else 0.0
        say(f"spec-decode: k={args.draft_k} windows={st['spec_windows']} "
              f"drafted={drafted} accepted={acc} accept_rate={rate:.2f} "
              f"emitted={st['spec_emitted_tokens']}")
    if mesh is not None:
        say(f"mesh: data={engine.dp} model={engine.tp} "
            f"heads_sharded={engine.heads_sharded} "
            f"slots/shard={args.batch // engine.dp}")
    ms = engine.metrics.summary()
    mc = ms["counters"]
    say(f"metrics: ticks={ms['ticks']} "
          f"queue_depth_mean={ms['gauges'].get('queue_depth', {}).get('mean', 0):.2f} "
          f"occupancy_mean={ms['gauges'].get('batch_occupancy', {}).get('mean', 0):.2f} "
          f"ttft_p95={1e3 * ms['ttft_s']['p95']:.1f}ms "
          f"itl_p95={1e3 * ms['itl_s']['p95']:.1f}ms "
          f"sink_errors={ms['sink_errors']}")
    say(f"fault: deadline_expired={int(mc.get('finish_deadline', 0))} "
          f"shed={int(mc.get('finish_shed', 0))} "
          f"recoveries={int(mc.get('recoveries', 0))} "
          f"slow_windows={int(mc.get('slow_windows', 0))} "
          f"degrade_events={int(mc.get('degrade_events', 0))}")
    if engine.trace.enabled:
        # end-of-run latency attribution (DESIGN.md §13): one line per
        # finished request, wall time decomposed into phase shares
        for r in sorted(done, key=lambda x: x.rid):
            say("explain " + format_explain(engine.explain(r.rid)))
        engine.trace.close()      # flush the jsonl feed, write the perfetto
        if engine.trace.perfetto_path:
            say(f"trace: wrote perfetto export to "
                  f"{engine.trace.perfetto_path} "
                  f"(open at https://ui.perfetto.dev)")
    engine.metrics.close()
    if started:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    serve_main()
