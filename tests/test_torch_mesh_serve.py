"""Sharded serving (DESIGN.md §9) of the port: ``Engine(mesh=...)`` over a
('data', 'model') ``DeviceMesh``, one process per rank, gloo on the CPU.

The serve layout splits no contraction — QKV column-parallel, the heads
all-gathered before a replicated W_O, slots and paged pools partitioned
on 'data', KV heads on 'model' — and the dither KV codes hash global
head indices, so on the CPU a sharded stream is the single-device stream
bit for bit.  These tests pin that on the (1, 1), (2, 1), (1, 2) and
(2, 2) meshes at ``smollm_135m.reduced()`` (4 heads / 2 KV heads): ring
and paged × bf16 and int8, speculative ≡ plain, sampled, windows with
chunked prefill, the GQA fallback, restore ≡ uninterrupted, each shard's
int8 cache bytes, and that every rank's host streams are equal.

Each mesh shape is one spawn (``tests/_torch_mesh.py``): a module-scoped
fixture runs every case of the shape once and the parametrised tests read
its results.  MoE and the matmul policy are not ≡ single device under a
mesh (capacity ranks and the activation absmax run over a shard's rows,
in both packages), so they are held to the reference's own sharded
engine, run in a subprocess with four virtual devices
(``tests/_torch_mesh_ref.py``), on margin-checked fixtures.  The (1, 1)
mesh is also held to the reference's (1, 1) mesh in process.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import _torch_mesh as mesh_cases
import repro.serve.engine as ref_engine
import repro_torch.serve.engine as port_engine
from repro.launch.mesh import make_serve_mesh as ref_make_serve_mesh
from repro_torch.dist.sharding import MeshShape
from repro_torch.interop import params_from_numpy
from test_torch_serve import (CFG, LOGIT_TOL, PARAMS, PORT_CFG, SAMPLING,
                              _check_decision, _requests)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2)]
IDS = {s: f"{s[0]}x{s[1]}" for s in SHAPES}
STREAMS = [f"stream-{lay}-{q}" for lay in ("ring", "paged")
           for q in ("bf16", "int8")]
COMMON = STREAMS + ["spec-ring", "spec-paged", "windows-ring",
                    "windows-paged", "cache-bytes", "errors"]
PLAN = {
    (1, 1): COMMON + ["pools", "metrics"],
    (2, 1): COMMON + ["pools", "restore-ring-int8", "restore-paged-bf16"],
    (1, 2): COMMON + ["gqa-ring", "gqa-paged", "restore-ring-int8",
                      "restore-paged-bf16"],
    (2, 2): COMMON + ["pools", "sampled", "ref-moe", "ref-policy"],
}
_RESULTS = {}


def _reference_streams(tmp):
    """The reference's (2, 2) streams of ``mesh_cases.REF_CASES`` →
    ``tmp/ref.json``, from a subprocess with four virtual devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    here = os.path.dirname(os.path.abspath(__file__))
    subprocess.run([sys.executable, os.path.join(here, "_torch_mesh_ref.py"),
                    os.path.join(tmp, "ref.json")], env=env, check=True,
                   timeout=600)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    def get(shape):
        if shape not in _RESULTS:
            tmp = str(tmp_path_factory.mktemp(f"mesh{IDS[shape]}"))
            if any(n.startswith("ref-") for n in PLAN[shape]):
                _reference_streams(tmp)
            _RESULTS[shape] = mesh_cases.run_mesh(shape, PLAN[shape], tmp)
        return _RESULTS[shape]
    return get


def _ranks(results, shape, name):
    """Every rank's result of case ``name`` on ``shape``; a case that
    raised fails here with its traceback."""
    outs = []
    for rank, res in enumerate(results(shape)):
        assert "error" not in res, res["error"]
        assert "error" not in res[name], f"rank {rank}:\n{res[name]['error']}"
        outs.append(res[name])
    return outs


def _same_on_every_rank(outs, key="got"):
    for rank, o in enumerate(outs[1:], 1):
        assert o[key] == outs[0][key], f"rank {rank}'s host streams differ"


@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS.get)
def test_mesh_streams_equal_single_device(results, shape, name):
    """Ring and paged × bf16 and int8: the sharded stream is the
    single-device stream bit for bit, on every rank; heads shard on the
    'model' axis (2 KV heads → 1 a rank at tp 2)."""
    outs = _ranks(results, shape, name)
    _same_on_every_rank(outs)
    assert outs[0]["got"] == outs[0]["want"]
    assert all(r == "length" and len(out) == 6
               for _, out, r in outs[0]["got"])
    tp = shape[1]
    assert outs[0]["heads_sharded"] is (tp > 1)
    assert outs[0]["local_kv_heads"] == 2 // tp
    assert outs[0]["window_mode"] == "eager"          # the CPU: no graphs


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS.get)
def test_spec_mesh_streams_equal_plain(results, shape, layout):
    """Speculative windows on the mesh emit the single-device plain
    stream."""
    outs = _ranks(results, shape, f"spec-{layout}")
    _same_on_every_rank(outs)
    assert outs[0]["got"] == outs[0]["want"]
    assert outs[0]["spec_windows"] > 0


def test_mesh_sampled_stream(results):
    """Temperature 0.8 (ring, int8) on the (2, 2) mesh: the sampler is a
    stateless per-row hash, so the stream is the single-device one."""
    outs = _ranks(results, (2, 2), "sampled")
    _same_on_every_rank(outs)
    assert outs[0]["got"] == outs[0]["want"]
    assert any(len(set(out)) > 1 for _, out, _ in outs[0]["got"])


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_gqa_fallback_keeps_heads_replicated(results, layout):
    """One KV head cannot split two ways: on (1, 2) the heads stay
    replicated (``heads_sharded`` False) and the stream is the
    single-device one."""
    outs = _ranks(results, (1, 2), f"gqa-{layout}")
    _same_on_every_rank(outs)
    assert outs[0]["got"] == outs[0]["want"]
    assert outs[0]["heads_sharded"] is False
    assert outs[0]["local_kv_heads"] == 1


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS.get)
def test_windows_with_chunked_prefill_equal_one_tick(results, shape, layout):
    """``decode_ticks=4`` with ``prefill_chunk=8`` (int8) on the mesh ≡ the
    single-device one-tick, whole-prompt stream."""
    outs = _ranks(results, shape, f"windows-{layout}")
    _same_on_every_rank(outs)
    assert outs[0]["got"] == outs[0]["want"]
    assert outs[0]["decode_calls"] < 36 / 4 + 4    # windows of 4 ticks


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (2, 2)], ids=IDS.get)
def test_pool_partitioned_per_shard(results, shape):
    """The paged pool splits into one host pool per data shard: the
    admission budget, trash id and device pool are shard-local, both
    shards serve, ``pool_stats`` sums the shards, every block comes
    back."""
    dp = shape[0]
    for o in _ranks(results, shape, "pools"):
        assert o["n_pools"] == dp
        assert o["num_blocks"] == 12 and o["nb_local"] == 12 // dp
        assert o["trash"] == [12 // dp] * dp
        assert o["device_blocks"] == 12 // dp + 1      # own pool + trash
        assert o["device_rows"] == 4 // dp
        assert o["done"] == 4 and o["shards_used"] == list(range(dp))
        assert o["live_after"] == 0 and o["summed"]
        assert all(0 < n <= 12 // dp for n in o["peak_live"])


def test_metrics_equal_stats_on_mesh(results):
    """Metrics ≡ stats and pool stats on the (1, 1) mesh, ring and paged
    (the reference's ``test_metrics_consistent_with_engine_stats``)."""
    (o,) = _ranks(results, (1, 1), "metrics")
    for layout, checks in o.items():
        assert all(checks.values()), (layout, checks)


@pytest.mark.parametrize("name", ["restore-ring-int8", "restore-paged-bf16"])
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=IDS.get)
def test_restore_equals_uninterrupted(results, shape, name):
    """A restore in place at two stops rebuilds each rank's cache byte for
    byte and continues the uninterrupted streams; five crashes in one run
    through ``run_serve_with_restarts`` (rank 0 writes every snapshot,
    each rank reads it) end in the same streams."""
    outs = _ranks(results, shape, name)
    _same_on_every_rank(outs, "crashed")
    for o in outs:
        assert o["bytes"] > 0
        assert o["inplace"] == [o["want"]] * 2
        assert o["crashed"] == o["want"]
        assert o["recoveries"] == 5 and len(o["fired"]) == 5


@pytest.mark.parametrize("shape", SHAPES, ids=IDS.get)
def test_int8_codes_of_each_shard_equal_single_device(results, shape):
    """After every step each rank's int8 ring cache — codes, scales and
    positions — is the single-device cache at its slot rows and global KV
    heads, byte for byte (the quantiser hashes global head indices)."""
    for o in _ranks(results, shape, "cache-bytes"):
        assert o["equal"], o
        assert o["bytes"] > 0


@pytest.mark.parametrize("shape", SHAPES, ids=IDS.get)
def test_mesh_errors(results, shape):
    """The reference's refusals: a batch the data axis does not divide,
    recurrent and encoder-decoder configs, and a snapshot of another
    mesh."""
    for o in _ranks(results, shape, "errors"):
        if shape[0] > 1:
            assert "multiple of the mesh's data axis" in o["batch"]
        for arch in ("mamba2_370m", "whisper_small"):
            assert "attention-only decoder" in o[arch]
        if shape == (1, 1):
            assert o["snapshot"] is None       # same layout as one device
        else:
            assert "snapshot layout does not match" in o["snapshot"]


@pytest.mark.parametrize("name", ["ref-moe", "ref-policy"])
def test_sharded_streams_equal_reference_sharded(results, name):
    """granite-moe (its capacity ranks over a shard's rows) and
    ``QuantPolicy(scheme='dither')`` (its activation absmax over a shard's
    rows) on the (2, 2) mesh: the port's streams equal the reference's
    sharded engine's, on fixtures whose every decision clears twice the
    logit tolerance on the port's side."""
    outs = _ranks(results, (2, 2), name)
    _same_on_every_rank(outs)
    assert [tuple(x) for x in outs[0]["got"]] == \
        [tuple(x) for x in outs[0]["want"]]
    max_new = mesh_cases.REF_CASES[name][-1]
    assert sum(o["decisions"] for o in outs[::2]) == sum(max_new)


# ------------------------------------------------- the (1, 1) mesh in process


def _reference_1x1(seed, layout, kv_quant, monkeypatch):
    """The reference engine on its (1, 1) mesh, its sampler recording every
    call (``tests/test_torch_serve._reference``); every deciding row must
    clear twice ``LOGIT_TOL``."""
    calls, holder = [], {}

    def record(*arrays):
        slots = holder["engine"].slots
        fresh = any(s is not None and not s.out for s in slots)
        calls.append(([np.array(a) for a in arrays],
                      [s is not None and (not s.out if fresh else True)
                       for s in slots]))

    def sample(*args):
        jax.debug.callback(record, *args)
        return original(*args)

    original = ref_engine.sample_tokens
    monkeypatch.setattr(ref_engine, "sample_tokens", sample)
    holder["engine"] = eng = ref_engine.Engine(
        PARAMS, CFG, batch=2, max_len=64, kv_quant=kv_quant,
        kv_layout=layout, block_size=8 if layout == "paged" else None,
        mesh=ref_make_serve_mesh(1, 1))
    for req in _requests(seed, ref_engine):
        eng.submit(req)
    done = sorted(eng.run(100), key=lambda r: r.rid)
    monkeypatch.undo()
    decisions = 0
    for i, ((logits, temps, topks, seeds, ctrs), decide) in enumerate(calls):
        for b in np.flatnonzero(decide):
            decisions += 1
            _check_decision(logits[b], temps[b], topks[b], seeds[b], ctrs[b],
                            LOGIT_TOL, context=f"call {i} row {b}")
    assert decisions == sum(row[2] for row in SAMPLING)
    return [(r.rid, r.finish_reason, r.out) for r in done]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_mesh_1x1_streams_equal_reference(layout, kv_quant, monkeypatch):
    """The port's engine on a (1, 1) mesh — no process group needed — and
    the reference's on its (1, 1) ``make_serve_mesh``: equal streams on
    margin-checked fixtures."""
    ref = _reference_1x1(23, layout, kv_quant, monkeypatch)
    params = params_from_numpy(jax.tree.map(np.asarray, PARAMS), "cpu")
    eng = port_engine.Engine(params, PORT_CFG, 2, 64, device="cpu", kv_quant=kv_quant,
                 kv_layout=layout, block_size=8 if layout == "paged" else None,
                 mesh=MeshShape(("data", "model"), (1, 1)))
    for req in _requests(23, port_engine):
        eng.submit(req)
    port = [(r.rid, r.finish_reason, r.out)
            for r in sorted(eng.run(100), key=lambda r: r.rid)]
    assert port == ref
