"""The sharded serving cases of ``tests/test_torch_mesh_serve.py``, run on
the CPU under gloo in one spawned process per rank.

``run_mesh(shape, cases, tmp)`` starts ``data × model`` processes, each
of which joins a gloo process group over a ``FileStore`` under ``tmp``
(never a fixed port: several test files run at once), builds the
('data', 'model') ``DeviceMesh`` with ``launch.mesh.make_serve_mesh`` and
runs every named case; each rank's results come back through a queue.
A case returns plain data (streams, booleans, byte counts): the tests
hold the mesh's streams to the single-device engine's, and every rank's
to rank 0's.

The model is ``smollm_135m.reduced()`` (4 heads / 2 KV heads, so a
2-way 'model' axis shards them) with the port's seed-0 weights; the
traffic is the reference's ``tests/test_sharded_serve.py`` mix: six
requests, prompts of 5–7 tokens, 6 new tokens each, batch 4.
"""

import dataclasses
import json
import os
import queue
import time
import traceback

import numpy as np
import torch

CASES = {}
# where the cases serve: "cpu" (gloo), or "cuda" for the card test, every
# rank on cuda:0 (``tests/test_torch_cuda.py``)
DEVICE = "cpu"


def case(name):
    def deco(fn):
        CASES[name] = fn
        return fn
    return deco


# --------------------------------------------------------------- harness


def _worker(rank, world, shape, store, tmp, names, q, device, modules=()):
    global DEVICE
    try:
        import importlib

        import torch.distributed as dist

        for mod in modules:          # modules that register more cases
            importlib.import_module(mod)

        DEVICE = device
        torch.set_num_threads(1)
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        from repro_torch.launch.mesh import make_serve_mesh

        mesh = make_serve_mesh(*shape, device=device)
        out = {}
        for name in names:
            try:
                out[name] = CASES[name](mesh, shape, tmp)
            except Exception:
                out[name] = {"error": traceback.format_exc()}
        q.put((rank, out))
        dist.destroy_process_group()
    except Exception:
        q.put((rank, {"error": traceback.format_exc()}))


def run_mesh(shape, names, tmp, timeout=600, device="cpu", modules=()):
    """Run ``names`` on a ``shape`` mesh → one result dict per rank;
    ``modules`` are imported in each rank first (they may add cases)."""
    import torch.multiprocessing as mp

    world = shape[0] * shape[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_worker,
                         args=(r, world, shape, store, tmp, list(names), q,
                               device, tuple(modules)))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + timeout
        while len(got) < world:
            try:
                rank, res = q.get(timeout=1.0)
                got[rank] = res
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in got]
                if dead and q.empty():
                    raise RuntimeError(f"mesh ranks {dead} exited without a "
                                       "result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"mesh {shape}: no result from ranks "
                                       f"{sorted(set(range(world)) - set(got))}"
                                       f" in {timeout} s") from None
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return [got[r] for r in range(world)]


# ----------------------------------------------------------------- serving

_PARAMS = {}
_BASE = {}


def cfg_of(n_kv_heads=None):
    from repro_torch.configs import get_config

    cfg = get_config("smollm_135m").reduced()
    if DEVICE == "cuda":         # the CUDA kernels take head dims 64 and 128
        cfg = dataclasses.replace(cfg, head_dim=64)
    return cfg if n_kv_heads is None else dataclasses.replace(
        cfg, n_kv_heads=n_kv_heads)


def params_of(cfg):
    from repro_torch.models import registry

    if cfg.n_kv_heads not in _PARAMS:
        _PARAMS[cfg.n_kv_heads] = registry.init_model(cfg, seed=0,
                                                      device=DEVICE)
    return _PARAMS[cfg.n_kv_heads]


def requests(cfg, temperature=0.0):
    from repro_torch.serve import Request, SamplingParams

    return [Request(rid=r, prompt=[(7 * r + i) % (cfg.vocab_size - 1) + 1
                                   for i in range(5 + r % 3)],
                    sampling=SamplingParams(temperature=temperature,
                                            max_new=6, seed=r,
                                            counter_offset=1000 * r))
            for r in range(6)]


def engine(cfg, mesh, **kw):
    from repro_torch.serve import Engine

    kw.setdefault("device", DEVICE)
    return Engine(params_of(cfg), cfg, 4, 48, mesh=mesh, **kw)


def streams(eng):
    return sorted((r.rid, tuple(r.out), r.finish_reason)
                  for r in eng.finished)


def serve(cfg, mesh, temperature=0.0, **kw):
    eng = engine(cfg, mesh, **kw)
    for r in requests(cfg, temperature):
        eng.submit(r)
    eng.run(200)
    return eng, streams(eng)


def baseline(cfg, temperature=0.0, **kw):
    """The single-device engine's streams (one tick, whole prompts)."""
    key = (cfg.n_kv_heads, temperature, tuple(sorted(kw.items())))
    if key not in _BASE:
        _BASE[key] = serve(cfg, None, temperature, **kw)[1]
    return _BASE[key]


def knobs(layout, kv_quant):
    kw = dict(kv_layout=layout, kv_quant=kv_quant)
    if layout == "paged":
        kw["block_size"] = 8
    return kw


def _stream_case(layout, kv_quant):
    def run(mesh, shape, tmp):
        cfg = cfg_of()
        eng, got = serve(cfg, mesh, **knobs(layout, kv_quant))
        return {"got": got, "want": baseline(cfg, **knobs(layout, kv_quant)),
                "heads_sharded": eng.heads_sharded,
                "local_kv_heads": eng._cfg_local.n_kv_heads,
                "window_mode": eng.window_mode}
    return run


for _layout in ("ring", "paged"):
    for _q in (False, True):
        case(f"stream-{_layout}-{'int8' if _q else 'bf16'}")(
            _stream_case(_layout, _q))


def _spec_case(layout):
    def run(mesh, shape, tmp):
        cfg = cfg_of()
        eng, got = serve(cfg, mesh, spec_decode=True, draft_k=4,
                         **knobs(layout, False))
        return {"got": got, "want": baseline(cfg, **knobs(layout, False)),
                "spec_windows": eng.stats["spec_windows"]}
    return run


case("spec-ring")(_spec_case("ring"))
case("spec-paged")(_spec_case("paged"))


@case("sampled")
def _sampled(mesh, shape, tmp):
    cfg = cfg_of()
    _, got = serve(cfg, mesh, temperature=0.8, **knobs("ring", True))
    return {"got": got,
            "want": baseline(cfg, 0.8, **knobs("ring", True))}


def _gqa_case(layout):
    def run(mesh, shape, tmp):
        cfg = cfg_of(n_kv_heads=1)
        eng, got = serve(cfg, mesh, **knobs(layout, True))
        return {"got": got, "want": baseline(cfg, **knobs(layout, True)),
                "heads_sharded": eng.heads_sharded,
                "local_kv_heads": eng._cfg_local.n_kv_heads}
    return run


case("gqa-ring")(_gqa_case("ring"))
case("gqa-paged")(_gqa_case("paged"))


def _windows_case(layout):
    def run(mesh, shape, tmp):
        cfg = cfg_of()
        eng, got = serve(cfg, mesh, decode_ticks=4, prefill_chunk=8,
                         **knobs(layout, True))
        return {"got": got, "want": baseline(cfg, **knobs(layout, True)),
                "prefill_calls": eng.stats["prefill_calls"],
                "decode_calls": eng.stats["decode_calls"]}
    return run


case("windows-ring")(_windows_case("ring"))
case("windows-paged")(_windows_case("paged"))


@case("pools")
def _pools(mesh, shape, tmp):
    """The paged pool partitioned per data shard: admission budget, trash
    id, block tables and the device pool are shard-local."""
    cfg = cfg_of()
    eng = engine(cfg, mesh, kv_layout="paged", block_size=8, num_blocks=12)
    out = {"n_pools": len(eng.pools), "num_blocks": eng.num_blocks,
           "nb_local": eng._nb_local,
           "trash": [p.trash for p in eng.pools],
           "device_blocks": eng.cache["layers"][0]["k"].shape[1],
           "device_rows": eng.cache["pos"].shape[0]}
    for r in range(4):
        from repro_torch.serve import Request, SamplingParams
        eng.submit(Request(rid=r, prompt=[r + 1] * 5,
                           sampling=SamplingParams(max_new=4)))
    seen, per_shard_live = set(), []
    while len(eng.scheduler) or any(s is not None for s in eng.slots):
        eng.step()
        seen |= {eng._slot_shard(i) for i, s in enumerate(eng.slots)
                 if s is not None}
        per_shard_live.append([p.live_blocks for p in eng.pools])
    stats = eng.pool_stats()
    out.update(done=len(eng.finished), shards_used=sorted(seen),
               live_after=stats["live"],
               summed=all(stats[k] == sum(p.stats[k] for p in eng.pools)
                          for k in eng.pools[0].stats),
               peak_live=[max(x[d] for x in per_shard_live)
                          for d in range(len(eng.pools))])
    return out


@case("metrics")
def _metrics(mesh, shape, tmp):
    """Metrics ≡ stats on the mesh (the reference's
    ``test_metrics_consistent_with_engine_stats`` on its (1, 1) mesh)."""
    cfg = cfg_of()
    out = {}
    for layout in ("ring", "paged"):
        eng, _ = serve(cfg, mesh, **knobs(layout, False))
        ms = eng.metrics.summary()
        g = ms["gauges"]
        done = eng.finished
        out[layout] = {
            "ttft_count": ms["ttft_s"]["count"] == len(done),
            "itl_count": ms["itl_s"]["count"] == sum(len(r.itl)
                                                     for r in done),
            "finished": ms["counters"]["finished_requests"] == len(done),
            "prefill": g["prefill_tokens"]["last"]
            == eng.stats["prefill_tokens"],
            "decode": g["decode_tokens"]["last"]
            == eng.stats["decode_tokens"],
            "ticks": ms["ticks"] > 0}
        if layout == "paged":
            ps = eng.pool_stats()
            out[layout]["live"] = g["live_blocks"]["last"] == ps["live"]
            out[layout]["cached"] = g["cached_blocks"]["last"] == ps["cached"]
    return out


def _restore_case(layout, kv_quant):
    """Restore ≡ uninterrupted: in place at several stops (this rank's
    rebuilt cache byte for byte the uninterrupted one's), and through
    ``run_serve_with_restarts`` with all five crash points in one run
    (rank 0 writes the snapshot, every rank reads it)."""
    def run(mesh, shape, tmp):
        from repro_torch.dist.fault_tolerance import (
            SERVE_PHASES, FailureInjector, run_serve_with_restarts)
        from repro_torch.serve import Engine

        cfg = cfg_of()
        kw = knobs(layout, kv_quant)
        want = baseline(cfg, 0.8, **kw)
        out = {"want": want, "inplace": [], "bytes": 0}
        for stop in (2, 4):
            eng = engine(cfg, mesh, **kw)
            for r in requests(cfg, 0.8):
                eng.submit(r)
            for _ in range(stop):
                eng.step()
            before = eng.written_kv()
            eng.restore(json.loads(json.dumps(eng.snapshot())))
            n, nbytes = Engine.compare_written_kv(before, eng.written_kv())
            out["bytes"] += nbytes
            eng.run(300)
            out["inplace"].append(streams(eng))
        path = os.path.join(tmp, f"snap-{layout}-{int(kv_quant)}.json")
        crash = {1 + 2 * i: phase for i, phase in enumerate(SERVE_PHASES)}
        injector = FailureInjector(crash_at=crash)

        def make():
            return engine(cfg, mesh, injector=injector, snapshot_path=path,
                          **kw)

        def submit(e):
            for r in requests(cfg, 0.8):
                e.submit(r)

        eng = run_serve_with_restarts(make, submit, max_restarts=5,
                                      snapshot_path=path, ticks=300)
        out["crashed"] = streams(eng)
        out["recoveries"] = eng.metrics.counters["recoveries"]
        out["fired"] = sorted(injector.fired)
        return out
    return run


case("restore-ring-int8")(_restore_case("ring", True))
case("restore-paged-bf16")(_restore_case("paged", False))


@case("cache-bytes")
def _cache_bytes(mesh, shape, tmp):
    """After every step, this rank's int8 ring cache (codes, scales,
    positions) equals the single-device cache's slice at its slot rows
    and global KV heads, byte for byte."""
    cfg = cfg_of()
    kw = knobs("ring", True)
    single, mine = engine(cfg, None, **kw), engine(cfg, mesh, **kw)
    for e in (single, mine):
        for r in requests(cfg):
            e.submit(r)
    lo, rows = mine._lo, mine._rows
    h0, nh = mine._head0, mine._cfg_local.n_kv_heads
    checked = 0
    while len(single.scheduler) or any(s is not None for s in single.slots):
        single.step()
        mine.step()
        for a, b in zip(single.cache["layers"], mine.cache["layers"]):
            for name, t in a.items():
                want = t[:, lo:lo + rows]
                if name in ("k", "v", "k_scale", "v_scale"):
                    want = want[:, :, :, h0:h0 + nh]
                if not torch.equal(want, b[name]):
                    return {"equal": False, "step": single.tick, "at": name}
                checked += b[name].numel() * b[name].element_size()
    return {"equal": True, "bytes": checked}


@case("purity")
def _purity(mesh, shape, tmp):
    """The shard-purity probe of this mesh (``transformer.shard_purity``)
    at the cases' model, decode and 8-token prefill rows."""
    from repro_torch.models import transformer

    cfg = cfg_of()
    return {rows: transformer.shard_purity(params_of(cfg), cfg, 4, *shape,
                                           rows=rows) for rows in (1, 8)}


@case("errors")
def _errors(mesh, shape, tmp):
    """The reference's refusals: a batch the data axis does not divide, a
    model with recurrent state or an encoder, and a snapshot taken on
    another mesh."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry

    out = {}
    dp = shape[0]

    def raises(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    cfg = cfg_of()
    if dp > 1:
        from repro_torch.serve import Engine
        out["batch"] = raises(lambda: Engine(params_of(cfg), cfg, dp + 1, 32,
                                             device="cpu", mesh=mesh))
    for arch in ("mamba2_370m", "whisper_small"):
        c = get_config(arch).reduced()
        p = registry.init_model(c, device="cpu")
        from repro_torch.serve import Engine
        out[arch] = raises(lambda: Engine(p, c, 2 * dp, 32, device="cpu",
                                          mesh=mesh))
    other = engine(cfg, None)
    for r in requests(cfg):
        other.submit(r)
    other.step()
    snap = json.loads(json.dumps(other.snapshot()))
    out["snapshot"] = raises(lambda: engine(cfg, mesh).restore(snap))
    return out


# --------------------------------------------------------- the reference


def check_decision(logits, temp, top_k, seed, counter, tol, context):
    """``tests/test_torch_serve._check_decision`` on the port's side, with
    the port's hash (bit for bit the reference's): the decision survives a
    logit error of ``tol``."""
    from conftest import assert_argmax_margin
    from repro_torch.core import rounding

    if temp <= 0:
        assert_argmax_margin(logits, min_margin=2 * tol,
                             context=f"greedy {context}")
        return
    v = logits.shape[-1]
    k = min(int(top_k), v) if top_k > 0 else v
    thresh = np.sort(logits)[v - k] if k < v else -np.inf
    u = rounding.hash_uniform(int(seed), torch.arange(v, dtype=torch.int64),
                              int(counter)).numpy()
    gumbel = -np.log(-np.log(u + 1e-12) + 1e-12)
    wide = np.where(logits >= thresh - 2 * tol, logits, -np.inf)
    scores = wide / max(float(temp), 1e-6) + gumbel
    assert_argmax_margin(scores, min_margin=2 * tol / temp,
                         context=f"sampled {context}")
    rivals = np.sum(logits > logits[np.argmax(scores)] - 2 * tol) - 1
    assert rivals < k, (f"sampled {context}: the winner sits on the top-k "
                        "boundary — reseed the fixture")


# (case, arch, policy, batch, max_len, tol, temperature, seed, max_new by
# rid): the reference's sharded engine against the port's on the same
# weights, each seed margin-checked
REF_CASES = {
    "ref-moe": ("granite_moe_1b_a400m", None, 4, 64, 2.0 ** -7, 0.8, 1,
                (3, 2, 4, 3, 2)),
    "ref-policy": ("smollm_135m", "dither", 4, 32, 2.0 ** -3, 2.0, 3,
                   (2, 3, 2, 3, 2)),
}


def ref_requests(mod, cfg, temperature, seed, max_new):
    """One request per ``max_new`` entry: prompts of 3..20 tokens from
    ``seed``, sampled at ``temperature`` over the whole vocabulary."""
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=r, prompt=rng.integers(
        1, cfg.vocab_size, size=int(rng.integers(3, 21))).tolist(),
        sampling=mod.SamplingParams(temperature=temperature, top_k=0,
                                    seed=seed + r, max_new=n,
                                    counter_offset=1000 * r))
            for r, n in enumerate(max_new)]


def _ref_case(name):
    """The port's sharded streams on a reference case's traffic, every
    deciding row of its sampler margin-checked (a row's logits within
    ``tol`` of the reference's then decide the same token), beside the
    reference's streams, read from ``tmp/ref.json`` (written by
    ``tests/_torch_mesh_ref.py`` on the reference's own mesh)."""
    def run(mesh, shape, tmp):
        import repro_torch.serve.engine as port_engine
        from _torch_zoo import model
        from repro_torch.numerics.policy import QuantPolicy

        arch, policy, batch, max_len, tol, temp, seed, max_new = \
            REF_CASES[name]
        _, pcfg, _, tparams = model(arch)
        calls = []
        original = port_engine.sample_tokens

        def sample(logits, temps, topks, seeds, counters):
            calls.append([t.numpy().copy() for t in (logits, temps, topks,
                                                     seeds, counters)]
                         + [[s is not None and (not s.out if fresh() else
                                                True)
                             for s in eng.slots[eng._lo:eng._lo
                                                + eng._rows]]])
            return original(logits, temps, topks, seeds, counters)

        def fresh():
            return any(s is not None and not s.out for s in eng.slots)

        port_engine.sample_tokens = sample
        try:
            eng = port_engine.Engine(
                tparams, pcfg, batch, max_len, device="cpu", mesh=mesh,
                policy=(QuantPolicy(scheme=policy, backend="auto")
                        if policy else None))
            for r in ref_requests(port_engine, pcfg, temp, seed, max_new):
                eng.submit(r)
            eng.run(200)
        finally:
            port_engine.sample_tokens = original
        for i, (logits, temps, topks, seeds, ctrs, decide) in enumerate(
                calls):
            for b in np.flatnonzero(decide):
                check_decision(logits[b].astype(np.float64), temps[b],
                               topks[b], seeds[b], ctrs[b], tol,
                               context=f"{name} call {i} row {b}")
        with open(os.path.join(tmp, "ref.json")) as fh:
            want = [tuple(x) for x in json.load(fh)[name]]
        return {"got": [(r.rid, r.finish_reason, list(r.out))
                        for r in sorted(eng.finished, key=lambda r: r.rid)],
                "want": [(rid, reason, list(out)) for rid, reason, out in
                         want],
                "decisions": sum(int(np.sum(c[-1])) for c in calls)}
    return run


for _name in REF_CASES:
    case(_name)(_ref_case(_name))
