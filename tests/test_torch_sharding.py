"""The port's partition rules (``repro_torch.dist.sharding``) against the
reference's (``repro.dist.sharding``), entry for entry.

The port's specs are tuples of per-dim entries and its meshes are
``MeshShape``s; the reference's are ``PartitionSpec``s over
``AbstractMesh``es (as ``tests/test_sharding.py`` builds them).  Every
arch of ``ARCH_IDS`` is checked on the production meshes, (16, 16) and
(2, 16, 16), from the reference's own shape trees; the serving rules on
the serve meshes also from the port's own param and cache trees at
``.reduced()``.
"""

import dataclasses

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import ARCH_IDS, get_config
from repro.dist import sharding as ref_shd
from repro.models import registry as ref_registry
from repro_torch.configs import get_config as port_get_config
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import MeshShape
from repro_torch.interop import shard_serve_params
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry, transformer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _abstract_mesh(shape, names):
    try:
        return AbstractMesh(shape, names)  # jax >= 0.5 signature
    except TypeError:
        return AbstractMesh(tuple(zip(names, shape)))


PROD = {"16x16": (("data", "model"), (16, 16)),
        "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
SERVE = {f"{d}x{m}": (("data", "model"), (d, m))
         for d, m in ((1, 1), (2, 1), (1, 2), (2, 2))}


def _meshes(names, sizes):
    return MeshShape(names, sizes), _abstract_mesh(sizes, names)


def _flat(port_specs, ref_specs):
    """Both spec trees flattened in the same (JAX) order, each spec as a
    tuple of entries."""
    mine = jax.tree_util.tree_flatten(
        port_specs, is_leaf=lambda x: isinstance(x, tuple))[0]
    theirs = jax.tree_util.tree_flatten(
        ref_specs, is_leaf=lambda x: isinstance(x, P))[0]
    return mine, [tuple(s) for s in theirs]


def _assert_same(port_specs, ref_specs):
    mine, theirs = _flat(port_specs, ref_specs)
    assert len(mine) == len(theirs)
    assert mine == theirs


_SHAPES = {}


def _param_shapes(arch):
    if arch not in _SHAPES:
        cfg = get_config(arch)
        _SHAPES[arch] = jax.eval_shape(
            lambda k: ref_registry.init_model(k, cfg), jax.random.PRNGKey(0))
    return _SHAPES[arch]


@pytest.mark.parametrize("mesh", sorted(PROD))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh):
    mine, theirs = _meshes(*PROD[mesh])
    cfg = get_config(arch)
    shapes = _param_shapes(arch)
    _assert_same(shd.param_specs(shapes, cfg, mine),
                 ref_shd.param_specs(shapes, cfg, theirs))


@pytest.mark.parametrize("mesh", sorted(SERVE) + ["16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_param_specs_equal_reference(arch, mesh):
    """``serve_param_specs`` and ``serve_heads_shardable`` on the serve
    meshes and the production pod."""
    names, sizes = SERVE.get(mesh) or PROD[mesh]
    mine, theirs = _meshes(names, sizes)
    cfg = get_config(arch)
    shapes = _param_shapes(arch)
    _assert_same(shd.serve_param_specs(shapes, cfg, mine),
                 ref_shd.serve_param_specs(shapes, cfg, theirs))
    tp = dict(zip(names, sizes))["model"]
    assert shd.serve_heads_shardable(cfg, tp) == \
        ref_shd.serve_heads_shardable(cfg, tp)


@pytest.mark.parametrize("mesh", sorted(SERVE) + sorted(PROD))
def test_batch_specs_and_data_axes_equal_reference(mesh):
    names, sizes = SERVE.get(mesh) or PROD[mesh]
    mine, theirs = _meshes(names, sizes)
    cfg = get_config("smollm_135m")
    assert shd.data_axes(mine) == ref_shd.data_axes(theirs)
    ref = ref_shd.batch_specs(cfg, theirs)
    assert shd.batch_specs(cfg, mine) == {k: tuple(v) for k, v in ref.items()}


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "recurrentgemma_9b",
                                  "mamba2_370m", "whisper_small"])
def test_ring_cache_specs_equal_reference(arch):
    """The decode caches of every family at (128 slots, 32,768 tokens), as
    ``tests/test_sharding.py`` sizes them, on the production pod."""
    mine, theirs = _meshes(*PROD["16x16"])
    cfg = get_config(arch)
    frames = (jax.ShapeDtypeStruct((128, cfg.n_enc_tokens, cfg.d_model),
                                   "bfloat16") if cfg.is_encdec else None)
    cache = jax.eval_shape(
        lambda p, f: ref_registry.make_cache(p, cfg, 128, 32768, frames=f),
        _param_shapes(arch), frames)
    _assert_same(shd.cache_specs(cache, cfg, mine),
                 ref_shd.cache_specs(cache, cfg, theirs))


def _port_cache(cfg, layout, dp, kv_quant=True):
    params = registry.init_model(cfg, device="cpu")
    kw = dict(kv_layout="paged", block_size=8, data_shards=dp) \
        if layout == "paged" else {}
    return registry.make_cache(params, cfg, 4, 64, kv_quant=kv_quant,
                               device="cpu", **kw)


def _ref_cache(cfg, layout, dp, kv_quant=True):
    params = jax.eval_shape(lambda k: ref_registry.init_model(k, cfg),
                            jax.random.PRNGKey(0))
    kw = dict(kv_layout="paged", block_size=8, data_shards=dp) \
        if layout == "paged" else {}
    return jax.eval_shape(
        lambda p: ref_registry.make_cache(p, cfg, 4, 64, kv_quant=kv_quant,
                                          **kw), params)


# (serve mesh, layout, data_shards): the paged pool of one shard on every
# mesh, and of two shards on the meshes with a 2-way data axis
CACHE_CASES = [(m, lay, 1) for m in sorted(SERVE) for lay in ("ring", "paged")]
CACHE_CASES += [(m, "paged", 2) for m in sorted(SERVE) if SERVE[m][1][0] == 2]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("mesh,layout,dp", CACHE_CASES)
def test_serve_cache_specs_equal_reference(mesh, layout, dp, kv_quant):
    """The port's own ring and paged caches (``data_shards`` 1 and 2: the
    sub-pools back to back, one trash block each) have the reference's
    shapes and specs, leaf for leaf, on every serve mesh."""
    names, sizes = SERVE[mesh]
    mine, theirs = _meshes(names, sizes)
    pcfg = port_get_config("smollm_135m").reduced()
    cfg = get_config("smollm_135m").reduced()
    port = _port_cache(pcfg, layout, dp, kv_quant)
    ref = _ref_cache(cfg, layout, dp, kv_quant)
    assert [tuple(t.shape) for t in jax.tree_util.tree_leaves(
        port, is_leaf=lambda x: isinstance(x, torch.Tensor))] == \
        [tuple(s.shape) for s in jax.tree_util.tree_leaves(ref)]
    _assert_same(shd.cache_specs(port, pcfg, mine),
                 ref_shd.cache_specs(ref, cfg, theirs))


def test_ring_stack_axis_never_data_sharded():
    """Stacked ring entries carry the repeat axis first: the batch rule
    targets axis 1, never the repeat axis."""
    pcfg = port_get_config("smollm_135m").reduced()
    cache = _port_cache(pcfg, "ring", 1)
    specs = shd.cache_specs(cache, pcfg, MeshShape(("data", "model"),
                                                   (2, 1)))
    ent = specs["layers"][0]
    assert ent["k"][0] is None and ent["k"][1] == "data"
    assert ent["k_pos"][0] is None and ent["k_pos"][1] == "data"
    assert specs["pos"] == ("data",)


def test_production_meshes():
    assert make_production_mesh() == MeshShape(("data", "model"), (16, 16))
    assert make_production_mesh(multi_pod=True) == MeshShape(
        ("pod", "data", "model"), (2, 16, 16))
    assert make_production_mesh(multi_pod=True).size == 512


@pytest.mark.parametrize("n_kv_heads", [2, 1], ids=["sharded", "gqa"])
def test_shard_serve_params_slices_qkv_heads(n_kv_heads):
    """One rank's serve weights: the QKV projections and biases keep the
    contiguous head block at its 'model' coordinate, every other leaf is
    the full tensor itself; under the GQA fallback nothing is cut."""
    cfg = dataclasses.replace(port_get_config("qwen2_1_5b").reduced(),
                              n_kv_heads=n_kv_heads)
    params = registry.init_model(cfg, device="cpu")
    mesh = MeshShape(("data", "model"), (2, 2))
    split = shd.serve_heads_shardable(cfg, 2)
    for m in range(2):
        local = shard_serve_params(params, cfg, {"data": 1, "model": m}, mesh)
        attn, full = local["blocks"][0]["attn"], params["blocks"][0]["attn"]
        for name in ("wq", "wk", "wv", "bq", "bk", "bv"):
            if name not in full:
                continue
            n = full[name].shape[-1] // (2 if split else 1)
            want = full[name][..., m * n:(m + 1) * n] if split \
                else full[name]
            assert torch.equal(attn[name], want), name
            assert attn[name].is_contiguous()
        assert attn["wo"] is full["wo"]
        assert local["embed"] is params["embed"]


def _host_reorders(cfg, params, batch, dp, tp, rows):
    """op → whether this host's own libraries sum a shard's outputs in
    another order than the same slice at the single-device shape, read
    off the libraries directly: torch's CPU ops of each probed op
    (``policy.matmul``'s f32 GEMM, the f32 mean square of the norm,
    ``layers.grouped_logits`` / ``grouped_values``) at one shard's local
    shapes and at the global ones, on operands whose summed dim carries
    4096 at both ends in one factor and ±4096 in the other (the two
    products cancel, so an order change moves nearly every output).
    The GEMM's order depends on the host (its ISA and BLAS build pick the
    kernel by the row count): this is the order the probe must find."""
    from repro_torch.models import layers
    from repro_torch.numerics.policy import matmul

    gen = torch.Generator().manual_seed(5)
    b = batch // dp
    split = shd.serve_heads_shardable(cfg, tp)

    def lead(shape, dim=-1, last=4096.0):
        t = torch.randn(shape, generator=gen)
        t.narrow(dim, 0, 1).fill_(4096.0)
        t.narrow(dim, t.shape[dim] - 1, 1).fill_(last)
        return t.bfloat16()

    def differs(op, full_args, local_args, cut):
        full = op(*full_args)
        return not torch.equal(op(*local_args), cut(full))

    out = {}
    for name, w in transformer._verify_weights(params, cfg).items():
        width = cfg.d_model if w is None else w.shape[0]
        x = lead((batch, rows, width))
        if w is None:
            def op(a):
                af = a.float()
                return torch.mean(af * af, dim=-1, keepdim=True)
            out[name] = differs(op, (x,), (x[:b].contiguous(),),
                                lambda o: o[:b])
            continue
        wt = lead(tuple(w.shape), 0, -4096.0)
        n = wt.shape[1] // tp if split and name in ("wq", "wk", "wv") \
            else wt.shape[1]
        out[name] = differs(matmul, (x, wt), (x[:b].contiguous(),
                                              wt[:, :n].contiguous()),
                            lambda o: o[:b, ..., :n])
    if rows > 1:
        nkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd()
        h = nkv // tp if split else nkv
        q = lead((batch, rows, nkv, g, hd))
        k = lead((batch, rows, nkv, hd), last=-4096.0)
        out["attn_logits"] = differs(
            layers.grouped_logits, (q, k),
            (q[:b, :, :h].contiguous(), k[:b, :, :h].contiguous()),
            lambda o: o[:b, :h])
        probs = lead((batch, nkv, g, rows, rows))
        v = lead((batch, rows, nkv, hd), 1, -4096.0)
        out["attn_values"] = differs(
            layers.grouped_values, (probs, v),
            (probs[:b, :h].contiguous(), v[:b, :, :h].contiguous()),
            lambda o: o[:b, :, :h])
    return out


@pytest.mark.parametrize("mesh", [(1, 1), (2, 1), (1, 2), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_shard_purity_reads_zero_on_the_cpu(mesh):
    """The shard-purity probe at the serve meshes of the CPU tests (batch
    4, reduced SmolLM), decode and 8-token prefill rows: every op reads
    what this host's libraries do at its shapes (``_host_reorders``): 0
    where they sum a shard's outputs in the single-device order, on most
    hosts every op, which is what makes the CPU's sharded streams bitwise
    (``tests/test_torch_mesh_serve.py``); an AVX-512 host whose GEMM
    takes another kernel at 2 rows than at 4 reads its order change
    there."""
    cfg = port_get_config("smollm_135m").reduced()
    params = registry.init_model(cfg, device="cpu")
    for rows in (1, 8):
        got = transformer.shard_purity(params, cfg, 4, *mesh, rows=rows)
        assert set(got) == set(transformer.VERIFY_OPS) | (
            {"attn_logits", "attn_values"} if rows > 1 else set())
        want = _host_reorders(cfg, params, 4, *mesh, rows)
        assert {op: n > 0 for op, n in got.items()} == want, (rows, got)


def test_shard_purity_sees_an_order_change(monkeypatch):
    """The probe is not blind: a product that sums K in reverse at a
    shard's row count (every local call has fewer rows than the
    single-device one on a 4-way data axis) is an order change, and the
    probe counts the outputs it moves; without it the probe reads what
    this host's GEMM does at 1 row against 4 (its matrix-vector path may
    or may not sum in another order)."""
    cfg = port_get_config("smollm_135m").reduced()
    params = registry.init_model(cfg, device="cpu")
    assert {op: n > 0 for op, n in transformer.shard_purity(
        params, cfg, 4, 4, 1).items()} == _host_reorders(cfg, params, 4, 4,
                                                         1, 1)
    dense = transformer.dense

    def reversed_k(a, w, *args, **kw):
        if a.shape[0] == 4:
            return dense(a, w, *args, **kw)
        return dense(a.flip(-1), w.flip(0), *args, **kw)

    monkeypatch.setattr(transformer, "dense", reversed_k)
    got = transformer.shard_purity(params, cfg, 4, 4, 1)
    assert got["wq"] > 0 and got["wd"] > 0, got
