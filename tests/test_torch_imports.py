"""The port stands alone: it imports neither JAX, ``ml_dtypes`` nor
anything of the JAX package ``repro``, so it runs where JAX is not
installed.  Proved twice: in a subprocess with those modules blocked — it
imports every module of the port, serves a few requests over the ring
and the paged cache, speculatively, under the dither matmul policy, and
with metrics, tracing and a crash recovered from a snapshot, takes one
training step under the dither policy with compressed gradients and
encodes and multiplies pulse streams, sweeps the kernel autotuner and
reads its winner back from the cache file, and serves and trains the MoE and
VLM configs of the zoo (``models/moe.py``, the stub frontend's embeds)
and the recurrent ones (``models/ssm.py``, ``models/hybrid.py``) — and
by a scan of its sources and ``chip_smoke.py``."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "repro")

_CHILD = r"""
import importlib.abc, sys

BLOCKED = {blocked!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Block())
import torch
from repro_torch.configs import get_config
from repro_torch.models import registry
cfg = get_config("smollm_135m").reduced()
params = registry.init_model(cfg, seed=0, device="cpu")
cache = registry.make_cache(params, cfg, 2, 16, kv_quant=True, device="cpu")
logits, cache = registry.apply_decode(params, cfg,
                                      torch.tensor([1, 2]), cache)
assert logits.shape == (2, cfg.vocab_size) and bool(logits.isfinite().all())
from repro_torch.serve import Engine, Request
eng = Engine(params, cfg, 2, 16, kv_quant=True, kv_layout="paged",
             block_size=4, num_blocks=6, device="cpu")
for r in range(3):
    eng.submit(Request(rid=r, prompt=[1, 2, 3, 4, 5 + r], max_new=3))
assert [len(r.out) for r in eng.run(50)] == [3, 3, 3]
eng = Engine(params, cfg, 2, 16, kv_quant=True, spec_decode=True, draft_k=3,
             device="cpu")
for r in range(3):
    eng.submit(Request(rid=r, prompt=[1, 2, 1, 2, 5 + r], max_new=4))
assert [len(r.out) for r in eng.run(50)] == [4, 4, 4]
assert eng.stats["spec_windows"] > 0
from repro_torch.numerics.policy import QuantPolicy
for layout in ("ring", "paged"):
    eng = Engine(params, cfg, 2, 16, kv_quant=True, kv_layout=layout,
                 block_size=4, device="cpu",
                 policy=QuantPolicy(scheme="dither", backend="auto"))
    for r in range(3):
        eng.submit(Request(rid=r, prompt=[1, 2, 3, 4, 5 + r], max_new=3))
    assert [len(r.out) for r in eng.run(50)] == [3, 3, 3]
    assert eng.policy.backend == "torch-ref"
import json, os, tempfile
from repro_torch.dist.fault_tolerance import (FailureInjector,
                                              run_serve_with_restarts)
tmp = tempfile.mkdtemp()
snap = os.path.join(tmp, "snap.json")
feed = os.path.join(tmp, "metrics.jsonl")
injector = FailureInjector(crash_at={{2: "mid_window"}})
def make_engine():
    return Engine(params, cfg, 2, 16, kv_quant=True, kv_layout="paged",
                  block_size=4, device="cpu", metrics="jsonl:" + feed,
                  trace="mem,perfetto:" + os.path.join(tmp, "t.json"),
                  injector=injector, snapshot_path=snap)
def submit(eng):
    for r in range(3):
        eng.submit(Request(rid=r, prompt=[1, 2, 3, 4, 5 + r], max_new=3))
eng = run_serve_with_restarts(make_engine, submit, snapshot_path=snap,
                              ticks=50)
assert sorted(len(r.out) for r in eng.finished) == [3, 3, 3]
assert eng.metrics.counters["recoveries"] == 1
assert all(abs(sum(eng.explain(r.rid)["shares"].values()) - 1) < 0.01
           for r in eng.finished)
eng.trace.close()
eng.metrics.close()
assert json.load(open(os.path.join(tmp, "t.json")))["traceEvents"]
assert open(feed).read().count("queue_depth") > 0
fresh = Engine(params, cfg, 2, 16, kv_quant=True, kv_layout="paged",
               block_size=4, device="cpu")
fresh.restore(json.load(open(snap)))
assert len(fresh.finished) == 3
from repro_torch.core import ops, representations as rep
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.optim.adamw import AdamW
from repro_torch.train import trainer
state = trainer.init_train_state(cfg, seed=0, device="cpu")
step = trainer.make_train_step(
    cfg, AdamW(lr=1e-3), policy=QuantPolicy(scheme="dither", backend="auto"),
    grad_policy=QuantPolicy(scheme="dither"))
state, m = step(state, synthetic_batch(cfg, DataConfig(2, 8), 0,
                                       device="cpu"))
assert int(state["counter"]) == 1 and bool(m["loss"].isfinite())
gen = torch.Generator().manual_seed(0)
pulses = rep.dither_encode(gen, torch.rand(4, generator=gen), 16)
assert pulses.shape == (4, 16)
assert ops.multiply_estimate(gen, torch.rand(3), torch.rand(3), 16,
                             "dither").shape == (3,)
for arch in ("granite_moe_1b_a400m", "qwen2_moe_a2_7b", "internvl2_1b"):
    zc = get_config(arch).reduced()
    zp = registry.init_model(zc, seed=0, device="cpu")
    for layout in ("ring", "paged"):
        eng = Engine(zp, zc, 2, 16, kv_quant=True, kv_layout=layout,
                     block_size=4, device="cpu")
        for r in range(3):
            eng.submit(Request(rid=r, prompt=[1, 2, 3, 4, 5 + r], max_new=3))
        assert [len(r.out) for r in eng.run(50)] == [3, 3, 3]
    zs = trainer.init_train_state(zc, seed=0, device="cpu")
    zb = synthetic_batch(zc, DataConfig(2, 8), 0, device="cpu")
    assert ("embeds" in zb) == (arch == "internvl2_1b")
    zs, m = trainer.make_train_step(zc, AdamW(lr=1e-3))(zs, zb)
    assert bool(m["loss"].isfinite())
for arch in ("mamba2_370m", "recurrentgemma_9b"):
    zc = get_config(arch).reduced()
    zp = registry.init_model(zc, seed=0, device="cpu")
    eng = Engine(zp, zc, 2, 16, kv_quant=True, decode_ticks=2, device="cpu")
    for r in range(3):
        eng.submit(Request(rid=r, prompt=[1, 2, 3, 4, 5 + r], max_new=3))
    assert [len(r.out) for r in eng.run(50)] == [3, 3, 3]
    zs = trainer.init_train_state(zc, seed=0, device="cpu")
    zs, m = trainer.make_train_step(zc, AdamW(lr=1e-3))(
        zs, synthetic_batch(zc, DataConfig(2, 8), 0, device="cpu"))
    assert bool(m["loss"].isfinite())
from repro_torch.kernels import autotune, dispatch
os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tmp, "autotune.json")
autotune.clear_cache()
q = torch.randn(2, 2, 2, 32).bfloat16()
k, v = torch.randn(2, 2, 64, 2, 32).bfloat16()
k_pos = torch.arange(64, dtype=torch.int32).repeat(2, 1)
pos = torch.tensor([63, 20], dtype=torch.int32)
win, res = autotune.autotune_decode_attention(
    2, 64, 2, 2, 32, backend="torch-ref", dtype="bfloat16", repeats=1,
    launches=1, run=lambda blk: dispatch.decode_attention(
        q, k, v, k_pos, pos, block=blk, backend="torch-ref"))
assert len(res) == 4 and json.load(open(os.environ["REPRO_AUTOTUNE_CACHE"]))
autotune.clear_cache()
assert autotune.best_block("decode_attention", (2, 64, 2, 2, 32), "bfloat16",
                           16, "flash", "torch-ref") == win
del os.environ["REPRO_AUTOTUNE_CACHE"]
autotune.clear_cache()
import importlib, pkgutil, repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert set(["repro_torch.serve.kvpool", "repro_torch.serve.draft",
            "repro_torch.kernels.paged_decode_attention",
            "repro_torch.kernels.verify_attention",
            "repro_torch.kernels.paged_verify_attention",
            "repro_torch.kernels.quantize",
            "repro_torch.kernels.dither_matmul",
            "repro_torch.kernels.autotune",
            "repro_torch.core.quantizers",
            "repro_torch.core.matmul",
            "repro_torch.serve.metrics",
            "repro_torch.serve.trace",
            "repro_torch.dist.fault_tolerance",
            "repro_torch.coldstart",
            "repro_torch.core.representations", "repro_torch.core.ops",
            "repro_torch.core.theory", "repro_torch.optim.schedules",
            "repro_torch.optim.adamw", "repro_torch.optim.grad_compress",
            "repro_torch.data.pipeline", "repro_torch.data.mnist_like",
            "repro_torch.checkpoint.checkpointer",
            "repro_torch.train.trainer", "repro_torch.launch.train",
            "repro_torch.tree", "repro_torch.models.moe",
            "repro_torch.configs.granite_3_8b",
            "repro_torch.configs.minicpm_2b",
            "repro_torch.configs.internvl2_1b",
            "repro_torch.configs.granite_moe_1b_a400m",
            "repro_torch.configs.qwen2_moe_a2_7b",
            "repro_torch.configs.mamba2_370m",
            "repro_torch.configs.recurrentgemma_9b",
            "repro_torch.models.ssm", "repro_torch.models.hybrid"]) <= set(names)
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("ok")
"""


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(blocked=BLOCKED)],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


_IMPORT = re.compile(
    r"^\s*(import\s+(jax|jaxlib|ml_dtypes|repro)\b(?!_)"
    r"|from\s+(jax|jaxlib|ml_dtypes|repro)\b(?!_))", re.MULTILINE)


def test_sources_import_nothing_of_jax():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15 and all(f.exists() for f in files)
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _IMPORT.finditer(f.read_text())]
    assert not bad, bad
    assert _IMPORT.search("from repro.models import x")
    assert _IMPORT.search("import jax.numpy as jnp")
    assert not _IMPORT.search("from repro_torch.models import x")
