"""Serving launcher of the port: drive the ring engine over a synthetic
request mix on the card (or, with ``--device cpu``, on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_135m \\
      --requests 6 --batch 4 --max-new 8 --temperature 0.8 --top-k 40 \\
      --sched priority

Takes the subset of the reference launcher's flags that the port's engine
serves, plus ``--device``.  Weights are random, drawn from seed 0 (the
reference draws its own from ``PRNGKey(0)``, so the values differ).
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config
from repro_torch.models import registry
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.sampling import SamplingParams


def serve_main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=5)
    ap.add_argument("--kv-quant", action="store_true",
                    help="dither-quantised int8 KV cache")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 = softmax sampling")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0,
                    help="base sampling seed (request r uses seed + r)")
    ap.add_argument("--sched", default="fcfs", choices=["fcfs", "priority"],
                    help="admission policy ('priority' favours high "
                         "Request.priority; the demo gives odd rids +1)")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = registry.init_model(cfg, seed=0, device=args.device)
    engine = Engine(params, cfg, args.batch, args.max_len,
                    kv_quant=args.kv_quant, scheduler=args.sched,
                    device=args.device)
    for r in range(args.requests):
        prompt = [(7 * r + i) % (cfg.vocab_size - 1) + 1
                  for i in range(args.prompt_len)]
        engine.submit(Request(
            rid=r, prompt=prompt, priority=r % 2,
            sampling=SamplingParams(temperature=args.temperature,
                                    top_k=args.top_k, seed=args.seed + r,
                                    max_new=args.max_new,
                                    counter_offset=1000 * r)))
    t0 = time.time()
    done = engine.run(ticks=args.requests * (args.max_new + 6) + 20)
    dt = time.time() - t0
    for r in sorted(done, key=lambda x: x.rid):
        ttft = f"{1e3 * r.ttft:.0f}ms" if r.ttft is not None else "-"
        print(f"req {r.rid} [{r.finish_reason}] ttft={ttft}: {r.out}")
    st = engine.stats
    pf = st["prefill_tokens"] / st["prefill_s"] if st["prefill_s"] else 0.0
    dc = st["decode_tokens"] / st["decode_s"] if st["decode_s"] else 0.0
    print(f"served {len(done)}/{args.requests} requests in {dt:.2f}s on "
          f"{args.device} (prefill {pf:.0f} tok/s over "
          f"{st['prefill_calls']} calls, decode {dc:.0f} tok/s over "
          f"{st['decode_calls']} ticks)")


if __name__ == "__main__":
    serve_main()
