"""Sharded decode of the recurrent and encoder-decoder families on the
training layout (``transformer.decode_step`` / ``encdec.
decode_step_encdec`` under ``ctx.train_shard_scope``, params by
``interop.shard_train_params``, the cache by ``interop.shard_cache``)
against the reference's GSPMD decode under ``param_specs`` /
``cache_specs`` (``tests/_torch_decode_mesh_ref.py``, four virtual
devices), at (1, 2) and (2, 2), with no policy and under the fused
dither policy (kernel 6's plain sharded forms on the CPU):

* mamba2 ``.reduced()``: the SSD state cut by heads, ``in_proj``
  column-parallel with its columns gathered, ``y`` gathered for the
  gated norm, ``out_proj`` row-parallel;
* recurrentgemma ``.reduced()`` (rglru, rglru, attn): the RG-LRU state
  cut by width and gathered before the replicated ``out``, the MQA
  attention on local query heads over the replicated KV head;
* whisper ``.reduced()``: self- and cross-attention on local heads,
  the cross-KV cut by heads.

Four teacher-forced ticks from the reference's own prefilled cache
(``tests/_torch_decode_mesh.py``).  The bounds are
``tests/test_torch_train.py``'s: every tick's logits within
``LOGIT_TOL`` without a policy, and within ``TOL[True]`` (relative, mean
and max) under it; the gathered cache after the last tick within
``TOL[policy]`` (relative), its integer leaves equal.  Measured here
(max over the cases): see ``test_sharded_decode_matches_reference``.
``test_replicas_bitwise`` holds every rank's logits and replicated cache
leaves (``conv``, the RG-LRU's, the replicated KV head's) bit for bit
equal across 'model' ranks; ``test_one_rank_mesh_is_one_device`` the
(1, 1) mesh's decode bit for bit one device's."""

import numpy as np
import pytest
import torch

import _torch_decode_mesh as dm
import _torch_mesh
import _torch_train_mesh as tm
from repro_torch import interop
from repro_torch.dist import sharding
from repro_torch.dist.sharding import MeshShape
from test_torch_train import LOGIT_TOL, TOL
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CASES = [(m, p) for m in dm.MODELS for p in dm.POLICIES]
_RUN = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not _RUN:
        tmp = str(tmp_path_factory.mktemp("decode_mesh"))
        _RUN["tmp"] = tmp
        _RUN["ref"] = dm.reference(tmp)
        _RUN["port"] = {s: _torch_mesh.run_mesh(
            s, ["decode-mesh"], tmp, modules=("_torch_decode_mesh",))
            for s in dm.SHAPES}
    return _RUN


def _ids(v):
    return f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v


def _results(runs, shape, model, pol):
    out = []
    for r in runs["port"][shape]:
        res = r["decode-mesh"]
        assert "error" not in res, res.get("error")
        out.append((res["coord"], res[f"{model}/{pol}"]))
    return out


def _close(got, want, tol):
    d = np.abs(got - want)
    return (d.mean() <= tol["mean"] * np.abs(want).mean()
            and d.max() <= tol["max"] * np.abs(want).max())


@pytest.mark.parametrize("shape", dm.SHAPES, ids=_ids)
@pytest.mark.parametrize("model,pol", CASES)
def test_sharded_decode_matches_reference(runs, model, pol, shape):
    ranks = _results(runs, shape, model, pol)
    ref = runs["ref"][model]
    key = f"{shape[0]}x{shape[1]}/{pol}"
    policy = pol != "none"
    for t in range(dm.TICKS):
        got = np.concatenate([res["logits"][t] for c, res in sorted(
            ranks, key=lambda r: r[0]["data"]) if c["model"] == 0])
        want = ref[f"{key}/logits{t}"]
        assert got.shape == want.shape
        if policy:
            assert _close(got, want, TOL[True]), (model, pol, shape, t)
        else:
            assert np.abs(got - want).max() <= LOGIT_TOL, (
                model, shape, t, np.abs(got - want).max())
    with np.load(dm.ref_file(runs["tmp"], model)) as data:
        want_cache = dm.flat_paths(interop.cache_from_numpy(
            dm.load_tree(data, f"{key}/cache"), "cpu"))
    got_cache = ranks[0][1]["cache"]
    assert set(got_cache) == set(want_cache)
    for path, w in want_cache.items():
        g, dtype = got_cache[path]
        assert dtype == str(w.dtype), path
        if w.is_floating_point():
            assert _close(g, tm.f32(w), TOL[policy]), (model, pol, shape,
                                                       path)
        else:
            assert np.array_equal(g, tm.f32(w)), (model, pol, shape, path)


@pytest.mark.parametrize("shape", dm.SHAPES, ids=_ids)
@pytest.mark.parametrize("model,pol", CASES)
def test_replicas_bitwise(runs, model, pol, shape):
    """Ranks of one data shard: the logits bit for bit, and every cache
    leaf that ``cache_specs`` keeps whole on 'model'."""
    ranks = _results(runs, shape, model, pol)
    cfg, _ = tm.model(model)
    with np.load(dm.ref_file(runs["tmp"], model)) as data:
        start = interop.cache_from_numpy(dm.load_tree(data, "start"), "cpu")
    specs = dm.flat_paths(sharding.cache_specs(
        start, cfg, MeshShape(("data", "model"), shape)))
    by_data = {}
    for coord, res in ranks:
        by_data.setdefault(coord["data"], []).append(res)
    for group in by_data.values():
        assert all(r["logit_digests"] == group[0]["logit_digests"]
                   for r in group)
        for path, spec in specs.items():
            if "model" not in spec:
                assert len({r["digests"][path] for r in group}) == 1, path


@pytest.mark.parametrize("model,pol", CASES)
def test_one_rank_mesh_is_one_device(runs, model, pol):
    """The (1, 1) mesh's decode (the blocks of a one-rank mesh, the
    scope) is one device's decode bit for bit: logits every tick and the
    cache after the last."""
    cfg, params = tm.model(model)
    toks = dm.inputs(cfg)["ticks"]
    mesh = MeshShape(("data", "model"), (1, 1))
    coord = {"data": 0, "model": 0}
    start = dm.start_cache(runs["tmp"], model)
    one = dm.decode(params, cfg, interop.shard_cache(start, cfg, coord, mesh),
                    toks, tm.port_policy(pol))
    meshed = dm.decode(interop.shard_train_params(params, cfg, coord, mesh),
                       cfg, interop.shard_cache(start, cfg, coord, mesh),
                       toks, tm.port_policy(pol), mesh)
    assert all(torch.equal(a, b) for a, b in zip(one[0], meshed[0]))
    a, b = dm.flat_paths(one[1]), dm.flat_paths(meshed[1])
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert meshed[2] == {}
