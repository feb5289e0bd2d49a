"""Dry run of the port: for each (arch × shape × mesh) cell, does one rank's
step fit on an H100, and what are the roofline terms of that step?  The
port's counterpart of the reference's ``launch/dryrun.py``.

The reference forces 512 host devices and lowers every cell through XLA.
The port runs in one process as rank 0 of the mesh, on the **meta
device**, as the reference runs on fake host devices: a
``torch.distributed`` group on the ``"fake"`` backend (every collective
returns at once), ``init_device_mesh("cpu", (D, M))`` with axes ('data',
'model'), and every tensor on ``meta`` (shapes and dtypes, no storage).
No kernel is built or launched: on meta tensors every dispatch resolves
to the kernels' plain versions (``kernels/dispatch.resolve_backend``).
The model code is the code that trains and serves, run on this rank's
local shapes.

Cells (the reference's ``SHAPES`` and its skip rule, DESIGN.md §5):

  train_4k     ``trainer.make_train_step`` under ``train_shard_scope``,
               seq 4096, global batch 256
  prefill_32k  ``registry.apply_model`` on the training layout, no grad,
               seq 32768, global batch 32
  decode_32k   one ``registry.apply_decode``, cache 32768, batch 128.
               An attention-only decoder decodes as the port's sharded
               engine serves it (``"layout": "serve"``:
               ``serve_shard_scope``, ``serve_param_specs``, QKV split by
               heads, the heads all-gathered before W_O).  A family the
               engine does not serve on a mesh (recurrent state, an
               encoder: ``serve.engine.mesh_layout`` refuses it) decodes
               as the reference lowers every decode cell
               (``"layout": "train"``): params under ``train_param_specs``
               (``interop.shard_train_params``), the cache under
               ``cache_specs`` (``interop.shard_cache``), the step under
               ``train_shard_scope``; whisper's cross-KV is made from meta
               frames.
  long_500k    the same at cache 524288, batch 1 — sub-quadratic archs
               only

Meshes: "single" is (32, 8) and "multi" is (64, 8), in place of the
reference's v5e (16, 16) and (2, 16, 16): 'model' stays inside one host's
8 NVLink-connected cards; a 16-way 'model' axis would cross hosts.

Per cell, per rank:

* ``state_bytes`` — the train state's (params, m, v, the step and the
  counter) or the decode params' and cache's bytes, exact from the
  local shapes;
* ``peak_bytes`` — the most live bytes over the step: a dispatch mode
  counts every storage as it is allocated and as it is freed (the
  state included);
* ``flops`` — ``torch.utils.flop_counter.FlopCounterMode``: every
  matmul as often as it runs (recomputed layers, microbatches, chunk
  loops), so no loop factors are needed;
* ``streamed_bytes`` — from the same dispatch mode: every op that is not
  a view reads its inputs and writes its outputs once (no fusion: an
  upper bound, as the reference's HLO-parsed bytes);
* ``collectives`` — calls and bytes by kind, from ``dist.ctx``'s
  ``COLLECTIVES`` (training) and ``GATHERS`` (serving), which the fake
  group's ranks fill as the real ones do;
* ``memory_model_bytes`` and ``model_flops_total`` — the port's copies
  of the reference's ``analytic_memory_bytes`` and ``model_flops``;
* roofline seconds against the H100's published peaks: 989 TFLOP/s bf16
  dense, 3.35 TB/s HBM3, 80 GB, 450 GB/s each way over NVLink — the data
  sheet's, at a 700 W power limit.  Every collective is charged at the
  NVLink rate (an all-reduce twice its bytes, a gather once); the 'data'
  axis crosses hosts, whose link is slower, so the collective term is a
  lower bound there.

These are counts on the meta device against data-sheet peaks, not
measurements.

``launch/hlo_cost.py`` has no counterpart: torch has no HLO to parse, and
the dispatch-level counters above see every op as often as it runs, so
the loop weighting that module does is not needed.

A cell that raises is recorded with ``status: "error"``, its exception and
the tail of its trace, and the sweep goes on, as the reference's ``main``
does.  Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh single,multi --out build/dryrun_torch.json
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.config import ModelConfig

__all__ = ["SHAPES", "MESHES", "PEAK_FLOPS", "HBM_BW", "HBM_BYTES",
           "NVLINK_BW", "SkipCell", "model_flops", "analytic_memory_bytes",
           "fake_mesh", "MetaMemory", "measure", "run_cell",
           "collective_wire_bytes", "main"]

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# (data, model): 'model' inside one host's 8 NVLink-connected cards
MESHES = {"single": (32, 8), "multi": (64, 8)}

# H100 SXM data sheet, 700 W (per card)
PEAK_FLOPS = 989e12       # bf16 dense
HBM_BW = 3.35e12          # bytes/s
HBM_BYTES = 80e9
NVLINK_BW = 450e9         # bytes/s each way
# what --auto-microbatch fits a step under: 4 GB of the 80 left to the
# CUDA context, library workspaces and the collectives' buffers
HBM_BUDGET = 76e9

# collectives that all-reduce (≈ 2× their bytes on a ring); the rest gather
_REDUCES = ("copy_to_model", "reduce_from_model", "absmax", "partials",
            "grads", "loss")


class SkipCell(Exception):
    pass


def _decode_supported(cfg: ModelConfig, shape: str) -> bool:
    if shape != "long_500k":
        return True
    return cfg.sub_quadratic()


def model_flops(cfg: ModelConfig, kind: str, seq: int, batch: int) -> float:
    """6·N·D (train) / 2·N·D (forward) with N = active params."""
    n = cfg.param_count(active_only=bool(cfg.n_experts))
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch  # decode: one token per sequence


def analytic_memory_bytes(info: dict, sizes: dict) -> float:
    """Model-based per-device HBM traffic (the reference's roofline memory
    term, assuming TPU-grade fusion): train 3 bf16 param passes, f32 m/v
    read and written, ~12 activation passes a layer over the local token
    slab; prefill 1 param read and ~6 passes a layer; decode 1 param
    read and the cache.  ``sizes``: the mesh's axis name → size."""
    cfg, kind = info["cfg"], info["kind"]
    tp = sizes.get("model", 1)
    dp = math.prod(sizes.values()) // tp
    p_bytes = cfg.param_count() * 2.0 / tp
    tokens_dev = info["batch"] * info["seq"] / dp
    act_pass = tokens_dev * cfg.d_model * 2.0
    n_layers = cfg.n_layers + (cfg.n_enc_layers if cfg.is_encdec else 0)
    if kind == "train":
        opt = cfg.param_count() * (4.0 + 4.0) * 2.0 / tp
        return 3.0 * p_bytes + opt + 12.0 * act_pass * n_layers
    if kind == "prefill":
        return p_bytes + 6.0 * act_pass * n_layers
    cache = info.get("cache_bytes_global", 0.0) / max(dp, 1)
    return p_bytes + cache


# ----------------------------------------------------------- the fake mesh


def fake_mesh(dp: int, tp: int):
    """A ('data', 'model') ``DeviceMesh`` of ``dp × tp`` ranks on a fake
    process group, this process rank 0 (a group of another size is torn
    down first)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = dp * tp
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return init_device_mesh("cpu", (dp, tp), mesh_dim_names=("data", "model"))


# ------------------------------------------------------------ the counters


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class MetaMemory(TorchDispatchMode):
    """Live and peak bytes of storages, and the bytes every non-view op
    streams (its tensor inputs read, its outputs written).  A storage
    counts from its first appearance (``track`` it, or an op returns it)
    until it is freed."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.streamed = 0
        self._seen = set()

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self.track(t)
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.streamed += sum(_nbytes(t) for t in ins + outs)
        return out


def _snapshot() -> dict:
    from repro_torch.dist import ctx

    return {**{k: dict(v) for k, v in ctx.COLLECTIVES.items()},
            **{k: dict(v) for k, v in ctx.GATHERS.items()}}


def _collectives_since(before: dict) -> dict:
    now = _snapshot()
    out = {}
    for k, v in now.items():
        d = {f: v[f] - before[k][f] for f in ("calls", "bytes")}
        if d["calls"]:
            out[k] = d
    return out


def collective_wire_bytes(coll: dict) -> float:
    """Bytes on the wire a rank sends: an all-reduce ≈ 2× its size over a
    ring, a gather ≈ its result's size."""
    return sum((2.0 if k in _REDUCES else 1.0) * v["bytes"]
               for k, v in coll.items())


# -------------------------------------------------------------- the cells


def _meta_batch(cfg: ModelConfig, rows: int, seq: int, labels: bool):
    from repro_torch.models import registry

    spec = registry.batch_spec(cfg, rows, seq)
    if not labels:
        spec.pop("labels")
    return {k: torch.zeros(shape, dtype=dtype, device="meta")
            for k, (shape, dtype) in spec.items()}


def _rows(batch: int, dp: int) -> int:
    """A data shard's rows: the batch split over 'data', or the whole
    batch where 'data' does not divide it (the reference's validated spec
    leaves it replicated)."""
    return batch // dp if batch % dp == 0 else batch


def _local_state(cfg: ModelConfig, mesh, coord: dict):
    """Rank ``coord``'s train state on ``mesh``, on meta: params, m and v
    at their ``train_param_specs`` blocks; the counter a real CPU scalar
    (the step reads it on the host once)."""
    from repro_torch.train import trainer

    state = trainer.init_train_state(cfg, device="meta", mesh=mesh,
                                     coords=coord)
    state["counter"] = torch.zeros((), dtype=torch.int32)
    return state


def _state_bytes(tr) -> int:
    return sum(_nbytes(t) for t in tree.leaves(tr)
               if isinstance(t, torch.Tensor))


def _train(cfg, mesh, coord, meta, *, policy, microbatch, remat, **_):
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import trainer

    state = _local_state(cfg, mesh, coord)
    dp = mesh.shape[0]
    batch = _meta_batch(cfg, _rows(meta["batch"], dp), meta["seq"], True)
    step = trainer.make_train_step(cfg, AdamW(lr=1e-4), policy=policy,
                                   microbatch=microbatch, remat=remat,
                                   mesh=mesh)
    return state, batch, lambda: step(state, batch)


def _prefill(cfg, mesh, coord, meta, *, policy, chunks, **_):
    from repro_torch.dist import ctx
    from repro_torch.models import registry

    state = _local_state(cfg, mesh, coord)
    params = state["params"]
    dp = mesh.shape[0]
    batch = _meta_batch(cfg, _rows(meta["batch"], dp), meta["seq"], False)

    def run():
        with torch.no_grad(), ctx.train_shard_scope(mesh):
            # batch-chunked prefill: the rows stream through in waves
            return [registry.apply_model(
                params, cfg, {k: v[i::chunks] for k, v in batch.items()},
                policy=policy, remat=False) for i in range(chunks)]

    return params, batch, run


def _decode(cfg, mesh, coord, meta, *, policy, kv_quant, **_):
    from repro_torch import interop
    from repro_torch.dist import ctx
    from repro_torch.models import registry
    from repro_torch.serve.engine import mesh_layout

    if not registry.supports_batched_prefill(cfg):
        return _decode_train(cfg, mesh, coord, meta, policy=policy,
                             kv_quant=kv_quant)
    # the sharded engine's own layout, and its refusals
    meta["layout"] = "serve"
    dp, tp, shardable, cfg_l = mesh_layout(cfg, meta["batch"], mesh)
    rows = meta["batch"] // dp
    params = registry.init_model(cfg, device="meta")
    if shardable:
        params = interop.shard_serve_params(params, cfg, coord, mesh)
    cache = registry.make_cache(params, cfg_l, rows, meta["seq"],
                                kv_quant=kv_quant, device="meta")
    token = torch.zeros((rows,), dtype=torch.int32, device="meta")
    group = mesh.get_group("model") if tp > 1 else None
    meta["cache_bytes_global"] = float(_state_bytes(cache) * dp *
                                       (tp if shardable else 1))

    def run():
        with torch.no_grad(), ctx.serve_shard_scope(
                head0=0, heads_sharded=shardable, group=group):
            return registry.apply_decode(params, cfg_l, token, cache,
                                         policy=policy)

    return {"params": params, "cache": cache}, {"token": token}, run


def _decode_train(cfg, mesh, coord, meta, *, policy, kv_quant):
    """A decode cell on the training layout, as the reference lowers it:
    the global params and cache on meta cut to this rank's blocks, the
    step under ``train_shard_scope`` on the data shard's rows (the whole
    batch where 'data' does not divide it, as ``cache_specs`` leaves it)."""
    from repro_torch import interop
    from repro_torch.dist import ctx
    from repro_torch.models import registry

    meta["layout"] = "train"
    params = registry.init_model(cfg, device="meta")
    frames = (torch.zeros((meta["batch"], cfg.n_enc_tokens, cfg.d_model),
                          dtype=torch.bfloat16, device="meta")
              if cfg.is_encdec else None)
    with torch.no_grad():
        cache = registry.make_cache(params, cfg, meta["batch"], meta["seq"],
                                    frames, kv_quant=kv_quant,
                                    device="meta")
    meta["cache_bytes_global"] = float(_state_bytes(cache))
    cache = interop.shard_cache(cache, cfg, coord, mesh)
    params = interop.shard_train_params(params, cfg, coord, mesh)
    token = torch.zeros((_rows(meta["batch"], mesh.shape[0]),),
                        dtype=torch.int32, device="meta")

    def run():
        with torch.no_grad(), ctx.train_shard_scope(mesh):
            return registry.apply_decode(params, cfg, token, cache,
                                         policy=policy)

    return {"params": params, "cache": cache}, {"token": token}, run


_BUILD = {"train": _train, "prefill": _prefill, "decode": _decode}


def measure(cfg: ModelConfig, kind: str, seq: int, batch: int, mesh, *,
            policy=None, microbatch: int = 0, remat: bool = True,
            kv_quant: bool = False, chunks: int = 1) -> Dict[str, Any]:
    """This rank's step of ``kind`` ("train", "prefill" or "decode") at
    ``seq`` × global ``batch`` on ``mesh`` (a ('data', 'model') mesh of
    the fake group): the counts of the module docstring, without the
    roofline."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.dist import ctx

    meta = dict(kind=kind, seq=seq, batch=batch)
    coord = ctx.mesh_coordinate(mesh)
    state, batch, run = _BUILD[meta["kind"]](
        cfg, mesh, coord, meta, policy=policy, microbatch=microbatch,
        remat=remat, kv_quant=kv_quant, chunks=chunks)
    mem = MetaMemory()
    for t in tree.leaves(state) + list(batch.values()):
        if isinstance(t, torch.Tensor) and t.device.type == "meta":
            mem.track(t)
    before = _snapshot()
    flops = FlopCounterMode(display=False)
    with flops, mem:
        out = run()
    del out
    coll = _collectives_since(before)
    return {"cfg": cfg, **meta,
            "state_bytes": _state_bytes(state),
            "peak_bytes": mem.peak,
            "flops": float(flops.get_total_flops()),
            "streamed_bytes": float(mem.streamed),
            "collectives": coll,
            "collective_wire_bytes": collective_wire_bytes(coll)}


def _roofline(m: dict, sizes: dict) -> Dict[str, Any]:
    n_dev = math.prod(sizes.values())
    mem_model = analytic_memory_bytes(m, sizes)
    mf = model_flops(m["cfg"], m["kind"], m["seq"], m["batch"])
    terms = {"compute": m["flops"] / PEAK_FLOPS,
             "memory": mem_model / HBM_BW,
             "memory_streamed": m["streamed_bytes"] / HBM_BW,
             "collective": m["collective_wire_bytes"] / NVLINK_BW}
    dominant = max(("compute", "memory", "collective"),
                   key=lambda k: terms[k])
    return {"devices": n_dev,
            "per_rank": {k: m[k] for k in (
                "state_bytes", "peak_bytes", "flops", "streamed_bytes",
                "collectives", "collective_wire_bytes")},
            "roofline_seconds": terms, "dominant": dominant,
            "memory_model_bytes": mem_model, "model_flops_total": mf,
            "useful_flops_ratio": (mf / (m["flops"] * n_dev)
                                   if m["flops"] else 0.0)}


def run_cell(arch: str, shape: str, mesh_kind: str,
             auto_microbatch: bool = False, **kw) -> Dict[str, Any]:
    """One cell on the fake mesh ``MESHES[mesh_kind]``; with
    ``auto_microbatch``, train cells double their microbatches (prefill
    cells their row chunks) until the peak fits ``HBM_BUDGET``."""
    dp, tp = MESHES[mesh_kind]
    mesh = fake_mesh(dp, tp)
    sizes = {"data": dp, "model": tp}
    kind = SHAPES[shape]["kind"]
    mb = kw.pop("microbatch", 0) or 1
    cap = max(_rows(SHAPES[shape]["batch"], dp), 1)
    chunks = 1
    cfg = get_config(arch)
    try:
        if kind == "decode" and not _decode_supported(cfg, shape):
            raise SkipCell(f"{arch} × {shape}: needs sub-quadratic attention "
                           "(full-attention KV at 500k is skipped per "
                           "DESIGN.md §5)")
        while True:
            m = measure(cfg, kind, SHAPES[shape]["seq"],
                        SHAPES[shape]["batch"], mesh, microbatch=mb,
                        chunks=chunks, **kw)
            if not auto_microbatch or m["peak_bytes"] <= HBM_BUDGET:
                break
            if kind == "train" and mb < cap:
                mb *= 2
            elif kind == "prefill" and chunks < cap:
                chunks *= 2
            else:
                break
        out = _roofline(m, sizes)
        out.update(microbatch=mb, prefill_chunks=chunks,
                   fits_hbm=bool(m["peak_bytes"] <= HBM_BYTES),
                   status="ok")
        if kind == "decode":
            out["layout"] = m["layout"]
    except SkipCell as e:
        out = dict(status="skip", reason=str(e))
    out.update(arch=arch, shape=shape, mesh=mesh_kind, mesh_shape=[dp, tp])
    return out


def main(argv=None):
    from repro_torch.numerics.policy import QuantPolicy

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="build/dryrun_torch.json")
    ap.add_argument("--policy", default="none",
                    choices=["none", "dither", "stochastic", "deterministic"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--auto-microbatch", action="store_true",
                    help="double gradient-accumulation microbatches (prefill "
                         "row chunks) until the step fits the 80 GB card")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--kv-quant", action="store_true",
                    help="dither-quantised int8 KV cache for decode cells")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = args.mesh.split(",")
    policy = (None if args.policy == "none"
              else QuantPolicy(scheme=args.policy, backend="auto"))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                if (arch, shape, mk) in done:
                    continue
                t0 = time.time()
                try:
                    r = run_cell(arch, shape, mk, policy=policy,
                                 microbatch=args.microbatch,
                                 auto_microbatch=args.auto_microbatch,
                                 remat=not args.no_remat,
                                 kv_quant=args.kv_quant)
                except Exception as e:  # noqa: BLE001 — record, go on
                    r = dict(status="error", arch=arch, shape=shape, mesh=mk,
                             error=f"{type(e).__name__}: {e}",
                             trace=traceback.format_exc()[-2000:])
                r["wall_seconds"] = round(time.time() - t0, 1)
                results.append(r)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                peak = r.get("per_rank", {}).get("peak_bytes")
                print(f"[{r['status']:5s}] {arch:24s} {shape:12s} {mk:6s} "
                      f"dom={r.get('dominant', '-')} peak="
                      f"{'-' if peak is None else f'{peak / 1e9:.2f}GB'} "
                      f"wall={r['wall_seconds']}s", flush=True)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
