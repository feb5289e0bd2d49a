"""One run of one cell of the benchmark.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with as many CUDA cards as
the cell asks for.  The run makes the weights on the card and the
traffic from ``--seed``; warms up every prefill shape the cell's traffic
can hit and the decode window it replays; primes a closed loop of one
client per slot; zeroes the engine's counters; serves for ``--seconds``
through ``Engine.submit`` / ``Engine.step``; with ``--trace 1`` traces
whole steps after it under ``torch.profiler`` for the mix's
``trace_seconds``, until a prefill wave and a decode window fell inside;
under the dither policy records a sample of the products of a few more
steps; then frees the engine and judges a sample of the window's
requests against the float32 reference, and the products against the
scheme.
Its last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its
limit, also printed as the last lines of standard error.

Caches stay inside the checkout (``build/``): the port's kernel
libraries, which only a checkout's first run compiles.  The autotuner's
winner cache is left unset, so the engine takes its model pick and no
sweep runs.
"""

import time

_T0 = time.time()      # set-up counts from here, before the imports

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the JAX package and JAX itself, by top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None):
    """Top-level names in ``modules`` (default ``sys.modules``) that the
    benchmark must never load, compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


assert not forbidden_loaded(), forbidden_loaded()


def _caches():
    """Every cache the run may write, at fixed paths inside the checkout;
    the autotuner's winner file unset."""
    os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def _power_limit_w(index: int):
    """The card's power limit in watts from ``nvidia-smi`` (the peaks in
    ``peaks.py`` hold at 700 W), None where it cannot be read."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"
             ",nounits", "-i", str(index)], capture_output=True, text=True,
            timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) \
            and isinstance(out.get(k), dict) else v
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             model: dict = None, traffic: dict = None, check: dict = None,
             t_start: float = None, control: bool = False) -> dict:
    """Serve cell ``name`` and judge it; returns the result object (less
    its ``metrics`` and ``breakdown``) with ``e2e``, ``run`` and
    ``summary`` for the caller to print from.  ``model``, ``traffic`` and
    ``check`` override parts of the cell's files (the CPU tests' tiny
    sizes; ``check``'s keys replace the file's whole); ``control`` also
    reads the cell's control (``control.py``)."""
    import torch

    from bench import check as checks, products, program, spec, stats
    from bench import weights
    from bench import trace as tracing
    from bench.context import Run
    from bench.loop import ClosedLoop
    from bench.peaks import peaks
    from bench.traffic import Traffic

    t_start = _T0 if t_start is None else t_start
    c = spec.cell(name)
    conf = c["config"]
    cfg = _merge(conf["model"], model)
    mix = _merge(c["traffic"], traffic)
    chk = dict(c["check"], **(check or {}))
    dev = torch.device(device)

    port_cfg = program.model_config(conf, override=model)
    params = weights.make_params(cfg, seed, dev)
    reqs = Traffic(mix, seed, cfg["vocab_size"])
    engine = program.make_engine(params, port_cfg, mix["engine"], dev)
    if dev.type == "cuda" and engine.policy is not None \
            and engine.policy.backend != "cuda":
        raise RuntimeError(f"the policy runs on {engine.policy.backend!r}, "
                           "not kernel 6")
    loop = ClosedLoop(engine, reqs, program.make_request,
                      span=torch.profiler.record_function if trace else None)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # set-up: every prefill shape once, then the loop primed
    for s in reqs.warmup():
        loop.serve_alone(s)
    loop.prime()
    loop.step()
    sync()
    engine.reset_stats()
    tick0, out_open = engine.tick, loop.out_counts()
    t0 = time.time()
    setup_s = t0 - t_start
    while time.time() - t0 < seconds:
        loop.step()
    sync()
    t1 = time.time()
    win = stats.Window(t0, t1, out_open, loop.out_counts())
    e2e = stats.end_to_end(loop.requests, win)
    window = {"seconds": win.seconds, "stats": dict(engine.stats),
              "ticks": engine.tick - tick0}

    sl, summary = None, None
    if trace:
        def state():
            return {"stats": dict(engine.stats), "tick": engine.tick,
                    "out": loop.out_counts()}
        got = tracing.profile_steps(loop, float(mix["trace_seconds"]),
                                    state, cuda=dev.type == "cuda")
        summary = tracing.summarise(got)
        b, a = got.before, got.after
        by_rid = {r.rid: r for r in loop.requests}
        # a request's prefix-hit tokens: the engine's ``_pf_start`` (where
        # its own prefill began; 0 on the ring)
        sl = {"seconds": got.seconds, "busy_s": summary["busy_s"],
              "steps": got.steps, "ticks": a["tick"] - b["tick"],
              "stats": {k: a["stats"][k] - b["stats"][k]
                        for k in a["stats"]},
              "op_seconds": summary["op_seconds"],
              "requests": [(len(by_rid[rid].prompt),
                            int(getattr(by_rid[rid], "_pf_start", 0)),
                            b["out"].get(rid, 0), n)
                           for rid, n in a["out"].items()
                           if n > b["out"].get(rid, 0)]}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    run = Run(name, cfg, mix, peaks(kind), window, sl)
    recorded = products.record(loop, seed, slots=int(
        mix["engine"]["slots"]), **chk["products"]) \
        if "products" in chk else None

    # the program's state goes before the reference runs
    loop.open = False
    finished = e2e.pop("finished")
    del loop, engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    pol = mix["engine"].get("policy") or {}
    verdict = checks.judge(params, cfg, finished, chk, seed, control,
                           recorded, pol.get("bits"))
    del recorded

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device_info["power_limit_w"] = _power_limit_w(dev.index or 0)
    if trace:
        device_info.update(busy_s=sl["busy_s"], window_s=sl["seconds"])
    e2e["setup_s"] = setup_s
    return {"correct": verdict["correct"], "attempted": e2e["attempted"],
            "failed": e2e["failed"], "device": device_info,
            "checks": verdict["checks"], "sampled": verdict["sampled"],
            "readings": verdict["readings"],
            "e2e": e2e, "run": run, "summary": summary}


def result_line(res: dict, man: dict, name: str, trace: bool) -> dict:
    """The result object of a run: the cell's metrics of the run's kind
    by the manifest's names and units, ``checks`` last."""
    from bench import spec

    metrics = {}
    if trace:
        for m in spec.metrics_for(man["per_layer"], name):
            v = spec.metric_reader(m["name"])(res["run"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in spec.metrics_for(man["end_to_end"], name):
            v = res["e2e"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics,
           "device": res["device"]}
    if trace and res["summary"] is not None:
        out["breakdown"] = {k: res["summary"][k]
                            for k in ("device_ops", "idle_gaps")}
    out["checks"] = res["checks"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()

    from bench import spec

    man = spec.manifest()
    chips = next(w["chips"] for w in man["workloads"]
                 if w["name"] == args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: the cell needs {chips} CUDA card(s); torch sees "
              f"{seen} (torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}): no result", file=sys.stderr)
        return 2
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda")
    line = result_line(res, man, args.workload, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print(f"bench: the run loaded {bad}: no result", file=sys.stderr)
        return 3
    e2e = res["e2e"]
    print(f"bench: window {e2e['attempted']} finished, {e2e['n_ttft']} "
          f"first tokens, {e2e['emitted']} tokens; sampled "
          f"{res['sampled']['requests']} requests, "
          f"{res['sampled']['tokens']} tokens", file=sys.stderr)
    sl = res["run"].slice
    if sl is not None:
        print(f"bench: traced slice {sl['seconds']:.3f} s, {sl['steps']} "
              f"steps, {sl['ticks']} ticks, "
              f"{sl['stats'].get('prefill_tokens', 0)} prefill tokens",
              file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
