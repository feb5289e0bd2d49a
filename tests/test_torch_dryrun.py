"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's formulas, the port's own layout and real steps:

* its copies of ``model_flops`` and ``analytic_memory_bytes`` equal the
  reference's for every arch × shape, on both of the port's meshes;
* its per-rank state bytes equal the bytes of
  ``interop.shard_train_state``'s local leaves (reduced configs at
  (2, 2), rank (0, 0));
* its collectives, by kind, calls and bytes, equal those of the same step
  run for real by gloo ranks at (1, 2) and (2, 2) (rank 0);
* its counted FLOPs of a reduced train step at (1, 1) are 6·N·D + 3·A
  without recomputation and 6·N·D + 2·(N − N_embed − N_down)·D + 4·A
  with it, exactly: N the matmul weights (``param_count`` less the norm
  gains), D the tokens, A the forward attention products (4·B·S²·H·hd a
  layer).  Non-reentrant checkpointing stops recomputing after the last
  tensor the backward needs, so each layer's W_down product is not run
  again;
* a decode cell of the recurrent and encoder-decoder families runs on
  the training layout (``"layout": "train"``): its per-rank state bytes
  equal the bytes of ``interop.shard_train_params``' and
  ``interop.shard_cache``'s local leaves (reduced configs at (2, 2),
  rank (0, 0)), and its collectives equal those of the same tick decoded
  by gloo ranks at (1, 2) (``_torch_decode_mesh.decode_collectives``,
  the tick of ``tests/test_torch_decode_mesh.py``);
* the CLI sweeps every cell of the reference's grid on the CPU: train,
  prefill and decode cells ``ok`` (decode on the serving layout for an
  attention-only decoder, on the training layout for the rest), or
  ``skip`` by the reference's rule, and a rerun resumes from its output.
"""

import json
import os
import subprocess
import sys

import pytest

import _torch_decode_mesh as dm
import _torch_dryrun as td
import _torch_mesh
import _torch_train_mesh as tm
from repro.configs import ARCH_IDS
from repro_torch import interop, tree
from repro_torch.configs import get_config
from repro_torch.dist.sharding import MeshShape
from repro_torch.launch import dryrun
from repro_torch.train import trainer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
_RUN = {}


def _script(kind, tmp, extra_env=None):
    out = os.path.join(tmp, f"{kind}.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **(extra_env or {}))
    subprocess.run([sys.executable, os.path.join(HERE, "_torch_dryrun.py"),
                    kind, out], env=env, check=True, timeout=600)
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not _RUN:
        tmp = str(tmp_path_factory.mktemp("dryrun"))
        _RUN["ref"] = _script("ref", tmp)
        _RUN["port"] = _script("port", tmp)
        _RUN["gloo"] = {s: _torch_mesh.run_mesh(
            s, ["dryrun-collectives"] + (
                ["decode-collectives"] if s == (1, 2) else []), tmp,
            modules=("_torch_dryrun", "_torch_decode_mesh"))
            for s in td.COLLECTIVE_SHAPES}
    return _RUN


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_formulas_equal_the_reference(runs, arch):
    ref = runs["ref"]
    cfg = get_config(arch)
    for shape, meta in dryrun.SHAPES.items():
        kind, seq, batch = meta["kind"], meta["seq"], meta["batch"]
        assert dryrun.model_flops(cfg, kind, seq, batch) == \
            ref[f"{arch}/{shape}/flops"], (arch, shape)
        for mk, sizes in td.MESH_SIZES.items():
            info = dict(cfg=cfg, kind=kind, seq=seq, batch=batch,
                        cache_bytes_global=td.CACHE_BYTES)
            assert dryrun.analytic_memory_bytes(info, sizes) == \
                ref[f"{arch}/{shape}/{mk}/bytes"], (arch, shape, mk)


@pytest.mark.parametrize("name", td.STATE_MODELS)
def test_state_bytes_are_the_local_leaves(runs, name):
    cfg, _ = tm.model(name)
    local = interop.shard_train_state(
        trainer.init_train_state(cfg, seed=0, device="cpu"), cfg,
        {"data": 0, "model": 0}, MeshShape(("data", "model"), (2, 2)))
    want = sum(t.numel() * t.element_size() for t in tree.leaves(local))
    assert runs["port"]["state_bytes"][name] == want


@pytest.mark.parametrize("model,policy", td.COLLECTIVE_CASES,
                         ids=[f"{m}-{p}" for m, p in td.COLLECTIVE_CASES])
@pytest.mark.parametrize("shape", td.COLLECTIVE_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_collectives_equal_a_real_step(runs, model, policy, shape):
    key = td._key(model, policy, shape)
    real = runs["gloo"][shape][0]["dryrun-collectives"]
    assert "error" not in real, real.get("error")
    assert real[key], key
    assert runs["port"]["collectives"][key] == real[key]


@pytest.mark.parametrize("model", dm.MODELS)
def test_decode_state_bytes_are_the_local_leaves(runs, model):
    """A training-layout decode cell's per-rank state: the bytes of rank
    (0, 0)'s params and cache blocks at (2, 2)."""
    cfg, params = tm.model(model)
    mesh = MeshShape(("data", "model"), (2, 2))
    coord = {"data": 0, "model": 0}
    local = {"params": interop.shard_train_params(params, cfg, coord, mesh),
             "cache": interop.shard_cache(dm.empty_cache(cfg, params), cfg,
                                          coord, mesh)}
    want = sum(t.numel() * t.element_size() for t in tree.leaves(local))
    for pol in dm.POLICIES:
        got = runs["port"]["decode"][td._key(model, pol, (2, 2))]
        assert got["layout"] == "train"
        assert got["state_bytes"] == want


@pytest.mark.parametrize("model,pol", [(m, p) for m in dm.MODELS
                                       for p in dm.POLICIES])
def test_decode_collectives_equal_a_real_tick(runs, model, pol):
    """The dry run's decode tick at (1, 2) against the same tick decoded
    by gloo ranks: calls and bytes by kind, rank 0."""
    real = runs["gloo"][(1, 2)][0]["decode-collectives"]
    assert "error" not in real, real.get("error")
    got = runs["port"]["decode"][td._key(model, pol, (1, 2))]
    assert real[f"{model}/{pol}"]
    assert got["collectives"] == real[f"{model}/{pol}"]


def test_flops_are_6nd_with_the_recompute(runs):
    cfg, params = tm.model("smollm")
    n = cfg.param_count() - 2 * cfg.d_model * cfg.n_layers   # less norms
    d = tm.BATCH * tm.SEQ
    attn = 4 * tm.BATCH * tm.SEQ ** 2 * cfg.n_heads * cfg.hd() * cfg.n_layers
    n_embed = params["embed"].numel()
    n_down = sum(b["mlp"]["wd"].numel() for b in params["blocks"])
    assert runs["port"]["flops/remat=False"] == 6 * n * d + 3 * attn
    assert runs["port"]["flops/remat=True"] == \
        6 * n * d + 2 * (n - n_embed - n_down) * d + 4 * attn


def test_cli_sweeps_and_resumes(tmp_path):
    """Two archs over every shape on the "single" mesh: the reference's
    cells and statuses; a second run with one more arch adds only its
    cells (granite-3-8b's sharded decode gathers its heads)."""
    out = str(tmp_path / "dryrun.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")

    def cli(archs):
        subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", archs, "--shape", "all", "--mesh",
                        "single", "--out", out], env=env, check=True,
                       timeout=600, capture_output=True)
        with open(out) as f:
            return json.load(f)

    first = cli("smollm_135m,mamba2_370m")
    got = {(r["arch"], r["shape"]): r for r in first}
    assert len(first) == 8
    for arch in ("smollm_135m", "mamba2_370m"):
        for shape in ("train_4k", "prefill_32k"):
            r = got[arch, shape]
            assert r["status"] == "ok", r
            assert r["mesh_shape"] == [32, 8]
            assert r["per_rank"]["flops"] > 0
            assert 0 < r["per_rank"]["state_bytes"] <= \
                r["per_rank"]["peak_bytes"]
            assert set(r["roofline_seconds"]) == {
                "compute", "memory", "memory_streamed", "collective"}
    # 3 KV heads do not split 8 ways: the engine keeps the heads whole
    # (the GQA fallback), and decode gathers nothing
    assert got["smollm_135m", "decode_32k"]["status"] == "ok"
    assert got["smollm_135m", "decode_32k"]["per_rank"]["collectives"] == {}
    assert got["smollm_135m", "long_500k"]["status"] == "skip"
    assert got["smollm_135m", "decode_32k"]["layout"] == "serve"
    # the engine serves no recurrent state on a mesh: mamba2 decodes on
    # the training layout, its SSD state cut by heads
    for shape in ("decode_32k", "long_500k"):
        r = got["mamba2_370m", shape]
        assert r["status"] == "ok" and r["layout"] == "train", r
        assert r["per_rank"]["collectives"]["gather_from_model"]["calls"] \
            == 2 * get_config("mamba2_370m").n_layers + 1
    again = cli("smollm_135m,mamba2_370m,granite_3_8b")
    assert again[:8] == first
    assert [r["arch"] for r in again[8:]] == ["granite_3_8b"] * 4
    # 8 KV heads split 8 ways: one gather of the heads before each W_O
    dec = next(r for r in again if r["arch"] == "granite_3_8b"
               and r["shape"] == "decode_32k")
    assert dec["per_rank"]["collectives"]["heads"]["calls"] == \
        get_config("granite_3_8b").n_layers
