"""The port's kernel autotuner (``repro_torch.kernels.autotune``) against
the reference's (``repro.kernels.autotune``), on the CPU.

Counterparts of the reference's autotune tests (``test_dispatch.py``: small
shapes stay runnable, a measured sweep caches and persists its winner,
the merge-and-swap save under concurrent writers; ``test_trace.py``: the
observer's events and the weak unregister; ``test_decode_attention.py``:
``block=None`` ≡ the autotuner's block), then the port's own contracts:
with no cache the model pick is the launch the wrappers took before the
autotuner (the parent's ``ring_constants`` and ``plan`` and the 64-token
pool at full width, written out below as they were), the paged default
is the reference's pick at the reduced config, an explicit block is
honoured by ``torch-ref`` and a non-candidate raises ``ValueError``, and
a sweep given the same timings picks the reference's winner.

The two modules keep separate caches; every test starts and ends with
both empty and ``REPRO_AUTOTUNE_CACHE`` unset.  Attention tolerances are
the plain versions' (f32 allclose 1e-5, summation order only, as
``tests/test_torch_decode_attention.py``); the dither kernels' plain
versions are bit for bit at any block.
"""

import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import autotune as ref_autotune
from repro.kernels import dispatch as ref_dispatch
from repro.serve.trace import Tracer as RefTracer
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import autotune, dispatch, ref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import dither_matmul as dm
from repro_torch.kernels import verify_attention as va
from repro_torch.models import registry
from repro_torch.serve import Engine, Request, Tracer
from test_torch_decode_attention import _jax, _ring_inputs, _torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_caches(monkeypatch):
    """Both winner caches empty and no cache file, before and after."""
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setattr(ref_autotune, "_CACHE_LOADED_FROM", None)
    autotune.clear_cache()
    ref_autotune.clear_cache()
    yield
    autotune.clear_cache()
    ref_autotune.clear_cache()


# ---------------------------------------------------------------------------
# the parent's launch parameters, as the wrappers computed them
# ---------------------------------------------------------------------------


def _parent_ring_tile(cap):
    """``decode_attention.ring_constants``'s tile: shrink_block(64, cap)."""
    bk = min(64, cap)
    while cap % bk:
        bk -= 1
    return bk


def _parent_plan(m, k, n):
    """``dither_matmul.plan``'s decode grid: (mt, cps, splits)."""
    mt = next(t for t in (1, 4, 16) if 8 * t >= m)
    strips, chunks = -(-n // 16), -(-k // 32)
    cps = -(-chunks // max(1, (4 * 132) // strips))
    return mt, cps, -(-chunks // cps)


FULL = [get_config(a) for a in ARCH_IDS]


def _heads(cfg):
    nkv = max(1, cfg.n_kv_heads)
    return nkv, max(1, cfg.n_heads // nkv), cfg.hd()


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("cap", [7, 24, 48, 96, 128, 256, 1000, 1024, 1500,
                                 2048, 4096])
def test_ring_model_pick_is_the_parents_tile(cap, quant):
    """Kernels 1 and 3 at every full-width head shape of the zoo: the
    model pick is the parent's tile, the verify pick the decode pick, and
    the pick is among the candidates."""
    dtype = "int8" if quant else "bfloat16"
    for cfg in FULL:
        nkv, group, hd = _heads(cfg)
        shape = (8, cap, nkv, group, hd)
        pick = autotune.best_block("decode_attention", shape, dtype,
                                   8 if quant else 16, "flash", "cuda")
        assert pick == (_parent_ring_tile(cap),), (cfg.name, cap)
        assert pick in autotune.decode_attention_candidates(
            cap, hd=hd, group=group, quantized=quant)
        for kq in (2, 4, 8):
            assert autotune.best_block(
                "verify_attention", (8, cap, nkv, kq, group, hd), dtype,
                8 if quant else 16, "flash", "cuda") == pick


MATMUL_GRID = [(m, k, n) for m in (1, 8, 16, 33, 64, 128)
               for k in (64, 576, 600, 1536, 2048, 4096)
               for n in (5, 192, 576, 1536, 8960, 49152)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_model_pick_is_the_parents_plan(dtype):
    """Kernel 6: at every decode shape of the grid (the serve products
    among them) the model pick is the parent's plan, a candidate, and
    ``plan``'s default; prefill shapes take the compile-time tiles."""
    for m, k, n in MATMUL_GRID:
        pick = autotune.best_block("matmul", (m, k, n), dtype, 8, "dither",
                                   "cuda")
        assert pick == _parent_plan(m, k, n), (m, k, n)
        assert pick in autotune.matmul_candidates(m, k, n)
        p = dm.plan(m, k, n)
        assert (p["mt"], p["cps"], p["splits"]) == pick
    for m, k, n in ((129, 576, 200), (4096, 576, 1536), (4096, 576, 49152)):
        assert autotune.best_block("matmul", (m, k, n), dtype, 8, "dither",
                                   "cuda") == autotune.PREFILL_BLOCK
        assert autotune.matmul_candidates(m, k, n) == [autotune.PREFILL_BLOCK]


@pytest.mark.parametrize("max_len", [256, 512, 1024, 2048, 4096, 32768])
def test_paged_default_is_64_at_full_width(max_len):
    """The pool block at full width: 64 tokens (the parent's default),
    for every config, both cache dtypes, any batch."""
    for cfg in FULL:
        for b in (1, 8, 64):
            for quant in (False, True):
                assert autotune.best_block(
                    "paged_attention", (b, max_len) + _heads(cfg),
                    "int8" if quant else "bfloat16", 8 if quant else 16,
                    "flash", "cuda") == (64,), (cfg.name, max_len)


@pytest.mark.parametrize("max_len", [1, 4, 7, 8, 16, 20, 24, 31, 32, 40, 48,
                                     64, 96, 128, 200, 256, 1024])
def test_paged_default_is_the_references_pick_at_reduced(max_len):
    """At every reduced config the port's pool-block pick is the
    reference's ``best_block`` (what its engine takes by default) wherever
    that is at most 64, the card's largest; above it the port takes 64."""
    for cfg in (get_config(a).reduced() for a in ARCH_IDS):
        shape = (2, max_len) + _heads(cfg)
        for quant in (False, True):
            dtype = "int8" if quant else "bfloat16"
            want = ref_autotune.best_block("paged_attention", shape, dtype,
                                           8 if quant else 16, "flash",
                                           "xla-ref")
            got = autotune.best_block("paged_attention", shape, dtype,
                                      8 if quant else 16, "flash",
                                      "torch-ref")
            assert got == (want if want[0] <= 64 else (64,)), (cfg.name,
                                                               max_len)


@pytest.mark.parametrize("max_len", [16, 32, 48, 64, 128])
def test_paged_engine_default_block_matches_reference(max_len):
    """The engine's default pool block at the reduced config (no
    ``block_size``) is the reference engine's (its
    ``engine.py`` default from ``autotune.best_block``); its streams
    equal those of an engine given that block explicitly."""
    cfg = get_config("smollm_135m").reduced()
    params = registry.init_model(cfg, seed=0, device="cpu")
    want = ref_autotune.best_block("paged_attention", (2, max_len) +
                                   _heads(cfg), "int8", 8, "flash",
                                   "xla-ref")[0]
    streams = []
    for bs in (None, want):
        eng = Engine(params, cfg, 2, max_len, kv_quant=True,
                     kv_layout="paged", block_size=bs, device="cpu")
        assert eng.block_size == want
        for r in range(2):
            eng.submit(Request(rid=r, prompt=[1, 2, 3 + r], max_new=3))
        streams.append([r.out for r in sorted(eng.run(50),
                                               key=lambda r: r.rid)])
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# candidates and the working-set model
# ---------------------------------------------------------------------------


def test_working_set_model_follows_the_kernels_staging():
    """The attention model is ``flash_decode.cuh:Layout::bytes``: head dim
    256 at group 16 in bf16 takes the 167,440 bytes the header states; every
    full-width shape's candidates fit, kernel 6's static stages fit 48 KB;
    a shape over the opt-in limit has no candidate and no model pick."""
    assert autotune.attention_smem_bytes(hd=256, rows=16,
                                         quantized=False) == 167440
    for cfg in FULL:
        nkv, group, hd = _heads(cfg)
        for quant in (False, True):
            assert autotune.decode_attention_candidates(
                1024, hd=hd, group=group, quantized=quant)
            for kq in (1, 4, 8, 16):
                assert autotune.attention_smem_bytes(
                    hd=hd, rows=kq * group, quantized=quant) \
                    <= autotune.SMEM_OPTIN_BYTES
    for m, k, n in MATMUL_GRID:
        for blk in autotune.matmul_candidates(m, k, n):
            assert autotune.matmul_smem_bytes(blk, m=m) \
                <= autotune.SMEM_STATIC_BYTES
    assert autotune.decode_attention_candidates(
        1024, hd=1024, group=16, quantized=False) == []
    with pytest.raises(ValueError, match="no decode_attention candidate"):
        autotune.model_block("decode_attention", (8, 1024, 1, 16, 1024),
                             "bfloat16")


@pytest.mark.parametrize("m,k,n", [(8, 576, 576), (8, 576, 192),
                                   (8, 576, 1536), (8, 1536, 576),
                                   (8, 576, 49152), (100, 32, 5000),
                                   (1, 7, 3)])
def test_matmul_candidates_cover_every_chunk_once(m, k, n):
    """Every decode candidate's grid gives each 32-deep K chunk to exactly
    one split, and its row tile holds every row."""
    cands = autotune.matmul_candidates(m, k, n)
    assert len(cands) == len(set(cands)) >= 2 or k <= 32
    for blk in cands:
        p = dm.plan(m, k, n, blk)
        assert 8 * p["mt"] >= m
        seen = np.zeros(p["chunks"], np.int64)
        for s in range(p["splits"]):
            lo, hi = s * p["cps"], min(p["chunks"], (s + 1) * p["cps"])
            assert hi > lo
            seen[lo:hi] += 1
        assert (seen == 1).all(), blk


# ---------------------------------------------------------------------------
# counterparts of the reference's autotune tests
# ---------------------------------------------------------------------------


def test_best_block_small_shapes_stay_runnable():
    """``test_dispatch.py``: the pick at a CPU-scale shape runs; here on
    ``torch-ref`` through the dispatcher, equal to the reference's oracle
    (its matmul bit for bit, its attention within the f32 tolerance)."""
    rng = np.random.default_rng(4)
    a = rng.uniform(size=(32, 64)).astype(np.float32)
    b = rng.uniform(size=(64, 48)).astype(np.float32)
    blk = autotune.best_block("matmul", (32, 64, 48), "float32", 8, "dither",
                              "torch-ref")
    out = dispatch.matmul(torch.from_numpy(a), torch.from_numpy(b), bits=8,
                          block=blk, backend="torch-ref")
    want = ref_dispatch.matmul(jnp.asarray(a), jnp.asarray(b), bits=8,
                               backend="xla-ref")
    assert out.shape == (32, 48)
    assert np.array_equal(out.numpy(), np.asarray(want))
    arrs = _ring_inputs(3, b=2, cap=24, nkv=2, group=2, pos_vals=(5, 30))
    blk = autotune.best_block("decode_attention", (2, 24, 2, 2, 32),
                              "bfloat16", 16, "flash", "torch-ref")
    assert blk == (24,)
    got = dispatch.decode_attention(*_torch(arrs, False)[:5], block=blk,
                                    backend="torch-ref")
    q, k, v, kp, pos, _, _ = _jax(arrs, False)
    want = ref_oracle_decode(q, k, v, kp, pos, blk)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def ref_oracle_decode(q, k, v, kp, pos, block, ks=None, vs=None):
    return np.asarray(ref_dispatch.decode_attention(
        q, k, v, kp, pos, k_scale=ks, v_scale=vs, block=block,
        backend="xla-ref"))


def test_measured_sweep_caches_winner(tmp_path, monkeypatch):
    """``test_dispatch.py``: a sweep through the dispatcher times every
    candidate, caches the least time's block, persists it, and
    ``best_block`` returns it after the in-memory cache is cleared."""
    cache_file = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(cache_file))
    gen = torch.Generator().manual_seed(6)
    a, b = torch.rand((8, 96), generator=gen), torch.rand((96, 40),
                                                          generator=gen)
    base = dispatch.matmul(a, b, bits=8, backend="torch-ref")

    def run(block):
        out = dispatch.matmul(a, b, bits=8, scheme="dither",
                              block=tuple(block), backend="torch-ref")
        assert torch.equal(out, base)
        return out

    cands = autotune.matmul_candidates(8, 96, 40)[:2]
    winner, results = autotune.autotune_matmul(
        8, 96, 40, bits=8, scheme="dither", backend="torch-ref", run=run,
        repeats=2, launches=1, candidates=cands)
    assert len(results) == 2 and tuple(results[0]["block"]) == winner
    assert results[0]["seconds"] <= results[1]["seconds"]
    assert all(len(r["samples"]) == 2 and r["seconds"] == min(r["samples"])
               for r in results)
    assert json.loads(cache_file.read_text())
    autotune.clear_cache()
    assert autotune.best_block("matmul", (8, 96, 40), "float32", 8,
                               "dither", "torch-ref") == winner


def test_save_cache_atomic_merge_survives_concurrent_writers(tmp_path,
                                                             monkeypatch):
    """``test_dispatch.py``: the save merges (another process's entries
    kept, ours win on conflicts), swaps the file in and leaves no
    temporary file; the port writes the reference's file format byte for
    byte."""
    files = {}
    for name, mod in (("port", autotune), ("ref", ref_autotune)):
        cache_file = tmp_path / f"{name}.json"
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(cache_file))
        mod.clear_cache()
        cache_file.write_text(json.dumps(
            {"matmul|1x1x1|f32|8|dither|x": [4, 4, 4], "shared|key": [1]}))
        mod._CACHE["shared|key"] = (2,)
        mod._CACHE["quantize|8x8|f32|8|dither|x"] = (8, 8)
        mod.save_cache()
        merged = json.loads(cache_file.read_text())
        assert merged["matmul|1x1x1|f32|8|dither|x"] == [4, 4, 4]
        assert merged["shared|key"] == [2]
        assert merged["quantize|8x8|f32|8|dither|x"] == [8, 8]
        files[name] = cache_file.read_text()
        mod.clear_cache()
    assert files["port"] == files["ref"]
    assert not list(tmp_path.glob("*.tmp.*"))


_WRITER = r"""
import sys
from repro_torch.kernels import autotune
rank = int(sys.argv[1])
for i in range(40):
    autotune._CACHE[f"writer{rank}|{i}"] = (rank, i)
    autotune.save_cache()
"""


def test_save_cache_under_concurrent_processes(tmp_path):
    """Six processes save to one file at once (more writers than this
    test's cores need): a reader never sees a truncated or invalid file,
    the entry every writer found there survives, each writer's last save
    holds all its own entries, and no temporary file is left."""
    cache_file = tmp_path / "autotune.json"
    cache_file.write_text(json.dumps({"theirs|key": [7]}))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_AUTOTUNE_CACHE=str(cache_file))
    procs = [subprocess.Popen([sys.executable, "-c", _WRITER, str(r)],
                              env=env, cwd=str(ROOT)) for r in range(6)]
    reads = 0
    try:
        while any(p.poll() is None for p in procs):
            data = json.loads(cache_file.read_text())
            assert data["theirs|key"] == [7]
            reads += 1
    finally:
        for p in procs:
            p.wait(timeout=120)
    assert all(p.returncode == 0 for p in procs)
    data = json.loads(cache_file.read_text())
    assert data["theirs|key"] == [7] and reads > 0
    last = [k for k in data if k.startswith("writer")]
    assert last and all(v == [int(k[6:].split("|")[0]),
                              int(k.split("|")[1])]
                        for k, v in data.items() if k in last)
    assert not list(tmp_path.glob("*.tmp.*"))


def test_autotune_observer_feeds_cache_events():
    """``test_trace.py``: a tracer hears a model pick, then a cache hit
    with its block — the same names, keys and blocks as the reference's
    tracer hears for the same calls."""
    shape = (2, 64, 3, 3, 64)
    seen = {}
    for name, mod, tracer in (("port", autotune, Tracer),
                              ("ref", ref_autotune, RefTracer)):
        tr = tracer()
        block = mod.best_block("decode_attention", shape, "int8", 8, "flash",
                               "unit-test")
        key = mod.cache_key("decode_attention", shape, "int8", 8, "flash",
                            "unit-test")
        mod._CACHE[key] = block                          # a sweep ran
        mod.best_block("decode_attention", shape, "int8", 8, "flash",
                       "unit-test")
        del mod._CACHE[key]
        events = [r for r in tr.records() if r.get("kind") == "event"
                  and r["name"].startswith("autotune")]
        assert [e["name"] for e in events] == ["autotune_model_pick",
                                               "autotune_cache_hit"]
        assert events[0]["key"] == key
        assert tuple(events[1]["block"]) == tuple(block)
        seen[name] = [(e["name"], e["key"], e.get("block")) for e in events]
    assert seen["port"] == seen["ref"]


def test_dropped_tracer_unregisters_from_autotune():
    """``test_trace.py``: the observer set holds tracers weakly."""
    tr = Tracer()
    ref_ = weakref.ref(tr)
    assert tr in autotune._OBSERVERS
    del tr
    assert ref_() is None and all(o is not None for o in autotune._OBSERVERS)
    assert Tracer(enabled=False) not in autotune._OBSERVERS


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_autotuned_block_matches_explicit(quantized):
    """``test_decode_attention.py``: ``block=None`` on ``torch-ref`` (the
    whole-cap block) is bit for bit the dispatcher at the autotuner's
    pick for that shape (its largest tile, the cap), and both sit within
    the f32 tolerance of the reference's oracle at its own pick."""
    arrs = _ring_inputs(9, b=3, cap=64, nkv=2, group=2, quantized=quantized,
                        pos_vals=(5, 40, 63))
    q, k, v, kp, pos, ks, vs = _torch(arrs, quantized)
    dtype = "int8" if quantized else "bfloat16"
    bits = 8 if quantized else 16
    picked = autotune.best_block("decode_attention", (3, 64, 2, 2, 32),
                                 dtype, bits, "flash", "torch-ref")
    auto = dispatch.decode_attention(q, k, v, kp, pos, k_scale=ks,
                                     v_scale=vs, backend="torch-ref")
    explicit = dispatch.decode_attention(q, k, v, kp, pos, k_scale=ks,
                                         v_scale=vs, block=picked,
                                         backend="torch-ref")
    assert torch.equal(auto, explicit)
    ref_pick = ref_autotune.best_block("decode_attention", (3, 64, 2, 2, 32),
                                       dtype, bits, "flash",
                                       "pallas-interpret")
    jq, jk, jv, jkp, jpos, jks, jvs = _jax(arrs, quantized)
    want = ref_oracle_decode(jq, jk, jv, jkp, jpos, ref_pick, jks, jvs)
    np.testing.assert_allclose(explicit.numpy(), want, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# explicit blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bk", [8, 16, 32, 64])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_explicit_block_is_honoured_by_torch_ref(bk, quantized):
    """A given ring tile runs the plain recurrence at that tile — through
    the dispatcher and the wrappers alike, decode and verify — equal to
    the port's plain version at ``block=(bk,)`` bit for bit and to the
    reference's oracle at the same tile within the f32 tolerance."""
    arrs = _ring_inputs(bk, b=4, cap=64, quantized=quantized)
    q, k, v, kp, pos, ks, vs = _torch(arrs, quantized)
    want = ref.decode_attention_ref(q, k, v, kp, pos, ks, vs, block=(bk,))
    got = dispatch.decode_attention(q, k, v, kp, pos, k_scale=ks, v_scale=vs,
                                    block=(bk,), backend="torch-ref")
    assert torch.equal(got, want)
    assert torch.equal(da.decode_attention(q, k, v, kp, pos, ks, vs,
                                           block=(bk,)), want)
    jq, jk, jv, jkp, jpos, jks, jvs = _jax(arrs, quantized)
    np.testing.assert_allclose(
        got.numpy(), ref_oracle_decode(jq, jk, jv, jkp, jpos, (bk,), jks, jvs),
        atol=ATOL, rtol=RTOL)
    qv = torch.stack([q, q.flip(1)], dim=1)          # (B, kq=2, nkv, g, hd)
    wantv = ref.verify_attention_ref(qv, k, v, kp, pos - 1, ks, vs,
                                     block=(bk,))
    for got in (dispatch.verify_attention(qv, k, v, kp, pos - 1, k_scale=ks,
                                          v_scale=vs, block=(bk,),
                                          backend="torch-ref"),
                va.verify_attention(qv, k, v, kp, pos - 1, ks, vs,
                                    block=(bk,))):
        assert torch.equal(got, wantv)


def test_non_candidate_block_raises():
    """A block that is not a candidate at the call's shape raises
    ``ValueError`` — on ``torch-ref`` at the dispatcher, and at the
    wrappers before any launch — and never falls back to the model pick."""
    arrs = _ring_inputs(1, b=2, cap=48, pos_vals=(3, 47))
    q, k, v, kp, pos, _, _ = _torch(arrs, False)
    for bad in ((12,), (32,), (64,), (0,), (8, 8)):
        with pytest.raises(ValueError, match="not a candidate"):
            dispatch.decode_attention(q, k, v, kp, pos, block=bad,
                                      backend="torch-ref")
        with pytest.raises(ValueError, match="not a candidate"):
            da.decode_attention(q, k, v, kp, pos, block=bad)
    for ok in ((8,), (16,), (48,)):
        dispatch.decode_attention(q, k, v, kp, pos, block=ok,
                                  backend="torch-ref")
    qv = q[:, None].expand(2, 3, *q.shape[1:]).contiguous()
    with pytest.raises(ValueError, match="not a candidate"):
        dispatch.verify_attention(qv, k, v, kp, pos, block=(24,),
                                  backend="torch-ref")
    a, b = torch.rand(8, 64), torch.rand(64, 16)
    with pytest.raises(ValueError, match="not a candidate"):
        dispatch.matmul(a, b, bits=8, block=(2, 1, 2), backend="torch-ref")
    with pytest.raises(ValueError, match="not a candidate"):
        dispatch.matmul(torch.rand(200, 64), b, bits=8, block=(1, 2, 1),
                        backend="torch-ref")
    dispatch.matmul(torch.rand(200, 64), b, bits=8,
                    block=autotune.PREFILL_BLOCK, backend="torch-ref")
    with pytest.raises(ValueError, match="not a candidate"):
        dispatch.quantize(a, bits=8, block=(8, 128), backend="torch-ref")
    dispatch.quantize(a, bits=8, block=(), backend="torch-ref")
    pool_k = torch.zeros(5, 8, 2, 32, dtype=torch.bfloat16)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="not the pool's"):
        dispatch.paged_decode_attention(q, pool_k, pool_k, bt, pos,
                                        block=(16,), backend="torch-ref")
    with pytest.raises(ValueError, match="not the pool's"):
        dispatch.paged_verify_attention(qv, pool_k, pool_k, bt, pos,
                                        block=(4,), backend="torch-ref")
    dispatch.paged_decode_attention(q, pool_k, pool_k, bt,
                                    torch.tensor([3, 20], dtype=torch.int32),
                                    block=(8,), backend="torch-ref")


def test_cached_winner_that_is_no_candidate_raises(tmp_path, monkeypatch):
    """A cache file naming a block the kernel cannot take at that shape
    raises at the lookup; nothing falls back to the model pick."""
    cache_file = tmp_path / "autotune.json"
    key = autotune.cache_key("decode_attention", (8, 48, 3, 3, 64), "int8",
                             8, "flash", "cuda")
    cache_file.write_text(json.dumps({key: [32]}))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(cache_file))
    with pytest.raises(ValueError, match="not a candidate"):
        autotune.best_block("decode_attention", (8, 48, 3, 3, 64), "int8", 8,
                            "flash", "cuda")


# ---------------------------------------------------------------------------
# sweeps: the reference's winner for the same timings
# ---------------------------------------------------------------------------


SWEEPS = {
    "matmul": (lambda mod, run, cands: mod.autotune_matmul(
        8, 576, 576, bits=8, scheme="dither", backend="x", run=run,
        candidates=cands), autotune.matmul_candidates(8, 576, 576)),
    "quantize": (lambda mod, run, cands: mod.autotune_quantize(
        576, 1536, bits=8, scheme="dither", backend="x", run=run,
        candidates=cands), autotune.quantize_candidates(576, 1536)),
    "decode_attention": (lambda mod, run, cands:
                         mod.autotune_decode_attention(
                             8, 1024, 3, 3, 64, backend="x", run=run,
                             candidates=cands),
                         autotune.decode_attention_candidates(
                             1024, hd=64, group=3, quantized=True)),
    "verify_attention": (lambda mod, run, cands:
                         mod.autotune_verify_attention(
                             8, 1024, 3, 4, 3, 64, backend="x", run=run,
                             candidates=cands),
                         autotune.verify_attention_candidates(
                             1024, hd=64, kq=4, group=3, quantized=True)),
    "paged_attention": (lambda mod, run, cands:
                        mod.autotune_paged_attention(
                            8, 1024, 3, 3, 64, backend="x", run=run,
                            candidates=cands),
                        autotune.paged_attention_candidates(
                            1024, hd=64, group=3, quantized=True)),
}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", sorted(SWEEPS))
def test_sweep_picks_the_references_winner(kind, seed, monkeypatch):
    """A fake runner with fixed times (ties included): the port's sweep
    orders the candidates as the reference's does and caches the same
    winner, under the same key (verify's under decode's in the port)."""
    sweep, cands = SWEEPS[kind]
    rng = np.random.default_rng(seed)
    times = {c: float(t) for c, t in
             zip(cands, rng.integers(1, 4, size=len(cands)) * 1e-5)}
    monkeypatch.setattr(ref_autotune, "_time_block",
                        lambda run, block, repeats: times[tuple(block)])
    monkeypatch.setattr(autotune, "_time_block",
                        lambda run, block, repeats, launches:
                        [times[tuple(block)] * 2, times[tuple(block)]])
    got, got_res = sweep(autotune, None, cands)
    want, want_res = sweep(ref_autotune, None, cands)
    assert got == want
    assert [r["block"] for r in got_res] == [r["block"] for r in want_res]
    assert [r["seconds"] for r in got_res] == [r["seconds"] for r in want_res]
    shared = next(k for k in ref_autotune._CACHE)
    if kind == "verify_attention":
        shared = autotune.cache_key("decode_attention", (8, 1024, 3, 3, 64),
                                    "int8", 8, "flash", "x")
    assert autotune._CACHE == {shared: got}


def test_verify_sweep_sets_the_decode_tile(monkeypatch):
    """Kernels 1 and 3 take one tile: a verify sweep's winner is what the
    decode lookup returns, and a later decode sweep replaces it for both."""
    times = {(8,): 3.0, (16,): 1.0, (32,): 2.0, (64,): 4.0}
    monkeypatch.setattr(autotune, "_time_block",
                        lambda run, block, repeats, launches: [times[block]])
    args = ("int8", 8, "flash", "cuda")
    autotune.autotune_verify_attention(8, 1024, 3, 4, 3, 64, backend="cuda",
                                       run=None)
    assert autotune.best_block("decode_attention", (8, 1024, 3, 3, 64),
                               *args) == (16,)
    assert autotune.best_block("verify_attention", (8, 1024, 3, 4, 3, 64),
                               *args) == (16,)
    times[(32,)] = 0.5
    autotune.autotune_decode_attention(8, 1024, 3, 3, 64, backend="cuda",
                                       run=None)
    assert autotune.best_block("verify_attention", (8, 1024, 3, 8, 3, 64),
                               *args) == (32,)


def test_sweep_drops_only_a_wrappers_value_error():
    """A candidate whose runner raises ``ValueError`` (a wrapper's check,
    before any launch) is dropped; any other error propagates, as a CUDA
    fault must."""
    def run(block):
        if block == (16,):
            raise ValueError("the wrapper refused it")
        return torch.zeros(1)

    win, res = autotune.autotune_decode_attention(
        2, 64, 2, 2, 32, backend="torch-ref", run=run, dtype="bfloat16",
        repeats=1, launches=1)
    assert (16,) not in [tuple(r["block"]) for r in res] and len(res) == 3

    def broken(block):
        raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal memory"):
        autotune.autotune_decode_attention(
            2, 64, 2, 2, 32, backend="torch-ref", run=broken,
            dtype="bfloat16", repeats=1, launches=1)


def test_resolve_asks_again_only_when_the_cache_changes():
    """``resolve`` (the wrappers' per-call lookup) answers as
    ``best_block`` and tells a tracer of each key once per change of the
    winner cache."""
    tr = Tracer()
    shape, args = (8, 576, 576), ("bfloat16", 8, "dither", "cuda")
    for _ in range(3):
        assert autotune.resolve("matmul", shape, *args) == (1, 2, 9)
    key = autotune.cache_key("matmul", shape, *args)
    autotune._CACHE[key] = (4, 3, 6)
    for _ in range(3):
        assert autotune.resolve("matmul", shape, *args) == (4, 3, 6)
    del autotune._CACHE[key]
    assert autotune.resolve("matmul", shape, *args) == (1, 2, 9)
    names = [r["name"] for r in tr.records()
             if r.get("name", "").startswith("autotune")]
    assert names == ["autotune_model_pick", "autotune_cache_hit",
                     "autotune_model_pick"]


def test_tuned_engine_takes_the_cached_pool_block(tmp_path, monkeypatch):
    """A paged engine built with ``REPRO_AUTOTUNE_CACHE`` naming a sweep's
    winner lays its pool out at that block, and its tracer saw the cache
    hit; without the file it takes the model pick."""
    cfg = get_config("smollm_135m").reduced()
    params = registry.init_model(cfg, seed=0, device="cpu")
    shape = (2, 64) + _heads(cfg)
    key = autotune.cache_key("paged_attention", shape, "int8", 8, "flash",
                             "torch-ref")
    cache_file = tmp_path / "autotune.json"
    cache_file.write_text(json.dumps({key: [8]}))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(cache_file))
    eng = Engine(params, cfg, 2, 64, kv_quant=True, kv_layout="paged",
                 device="cpu", trace="mem")
    assert eng.block_size == 8 and eng.attn_block is None
    hits = [r for r in eng.trace.records()
            if r.get("name") == "autotune_cache_hit"]
    assert hits and hits[0]["key"] == key and hits[0]["block"] == [8]
    eng.submit(Request(rid=0, prompt=[1, 2, 3, 4, 5], max_new=3))
    assert len(eng.run(20)[0].out) == 3
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    autotune.clear_cache()
    assert Engine(params, cfg, 2, 64, kv_quant=True, kv_layout="paged",
                  device="cpu").block_size == 16
