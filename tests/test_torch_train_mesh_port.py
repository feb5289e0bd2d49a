"""The training mesh inside the port, and its pins against the
reference's pieces:

* the (1, 1) mesh's step, which runs the mesh path (the scope, the
  gradient bucket and the loss reduced over a one-rank 'data' group), is
  the single-device step bit for bit (losses, params, m and v over two
  steps, with no policy, the unfused and the fused dither policy, and
  granite-moe's sharded expert path under the unfused one);
* the sharded ``_fake_quant`` of a block (rows, columns, a token shard of
  the sequence split, a data shard of MoE's padded dispatch buffer) is the
  matching slice of the reference's ``_fake_quant`` of the global tensor,
  bit for bit;
* kernel 6's plain sharded forms (``ref.dither_matmul_scaled_ref`` with a
  ``MatmulBlock``, through the ``dither_matmul_sharded`` and
  ``dither_matmul_epilogue`` wrappers on the CPU) reassemble the unsharded
  product bit for bit over row, column (row-major and transposed weights)
  and K blocks, and at the defaults are unchanged;
* elastic restart: a checkpoint written at (2, 2) restores at (2, 1) and
  (1, 1) byte for byte (the reference's ``tests/test_elastic.py``);
* ``registry.batch_spec`` equals the reference's for all ten archs;
* the launcher under ``torchrun --nproc-per-node 2`` (gloo);
* the limits: query heads that straddle KV groups, attention's per-call
  K/V at tp > 1, a batch the data axis does not divide, microbatches that
  do not divide a shard.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh
import _torch_train_mesh as tm
from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models import registry as ref_registry
from repro.numerics import policy as ref_policy
from repro_torch.configs import get_config
from repro_torch.dist.sharding import ShardView
from repro_torch.kernels import dither_matmul as dm
from repro_torch.kernels import ref
from repro_torch.models import registry
from repro_torch.numerics import policy
from repro_torch.numerics.policy import QuantPolicy
from test_torch_train import TOL
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_RUN = {}


def _mesh(shape, names, tmp):
    res = _torch_mesh.run_mesh(shape, [f"train-{n}" for n in names], tmp,
                               modules=("_torch_train_mesh",))
    for r in res:
        for n in names:
            assert "error" not in r[f"train-{n}"], r[f"train-{n}"]["error"]
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not _RUN:
        tmp = str(tmp_path_factory.mktemp("train_mesh_port"))
        _RUN["one"] = _mesh((1, 1), ["one-rank"], tmp)
        _RUN["save"] = _mesh((2, 2), ["elastic-save", "limits"], tmp)
        _RUN["restore"] = {s: _mesh(s, ["elastic-restore"], tmp)
                           for s in ((2, 1), (1, 1))}
    return _RUN


@pytest.mark.parametrize("case", sorted(tm.ONE_RANK_CASES))
def test_one_rank_mesh_is_the_single_device_step(runs, case):
    got = runs["one"][0]["train-one-rank"][case]
    assert got["equal"] is True
    assert got["reduces"] == {"grads": tm.STEPS, "loss": tm.STEPS}


# --------------------------------------------------------- bitwise pins


def _quant(x, view=None, seed=5, counter=3):
    return policy._fake_quant(x, QuantPolicy(scheme="dither"), counter,
                              seed, view=view)


def _ref_quant(x, seed=5, counter=3):
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    out = ref_policy._fake_quant(xj, ref_policy.QuantPolicy(scheme="dither"),
                                 jnp.float32(counter), seed)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _with_max_in_each(x, blocks):
    """x with its largest magnitude placed in every block, so each block's
    own absmax is the global one (the mesh all-reduces it; here no group
    does)."""
    x = x.clone()
    top = float(x.abs().max()) * 1.5
    for sl in blocks:
        first = tuple(s.start or 0 for s in sl)
        x[first + (0,) * (x.dim() - len(first))] = top
    return x


BLOCK_CASES = {
    # name: (global shape, blocks as slices)
    "rows": ((12, 40), [(slice(0, 6), slice(None)),
                        (slice(6, 12), slice(None))]),
    "cols": ((12, 40), [(slice(None), slice(0, 20)),
                        (slice(None), slice(20, 40))]),
    "token-shard": ((4, 8, 24), [(slice(2, 4), slice(4, 8), slice(None)),
                                 (slice(0, 2), slice(0, 4), slice(None))]),
    "k-block": ((4, 8, 24), [(slice(0, 2), slice(None), slice(12, 24))]),
}


@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_sharded_fake_quant_is_the_slice_of_the_global_one(name):
    shape, blocks = BLOCK_CASES[name]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=gen).bfloat16()
    x = _with_max_in_each(x, blocks)
    want = _ref_quant(x)
    assert torch.equal(_quant(x).float(), want)
    for sl in blocks:
        off = tuple(s.start or 0 for s in sl)
        got = _quant(x[sl].contiguous(), ShardView(shape, off))
        assert torch.equal(got.float(), want[sl]), (name, sl)


def test_sharded_fake_quant_hashes_the_padded_expert_buffer():
    """MoE at (2, 2): each data shard's (E, cap, d) dispatch buffer with
    5 experts rounds as its block of the reference's padded (dp, e_pad =
    6, cap, d) buffer — whose index the padding shifts."""
    dp, e, e_pad, cap, d = 2, 5, 6, 3, 16
    gen = torch.Generator().manual_seed(2)
    glob = torch.zeros((dp, e_pad, cap, d), dtype=torch.bfloat16)
    glob[:, :e] = torch.randn((dp, e, cap, d), generator=gen).bfloat16()
    glob = _with_max_in_each(glob, [(slice(s, s + 1),) for s in range(dp)])
    want = _ref_quant(glob)
    for s in range(dp):
        got = _quant(glob[s:s + 1, :e].contiguous(),
                     ShardView((dp, e_pad, cap, d), (s, 0, 0, 0)))
        assert torch.equal(got.float(), want[s:s + 1, :e])
    # unpadded, the index differs: the pin has teeth
    flat = _quant(glob[1:2, :e].contiguous(),
                  ShardView((dp, e, cap, d), (1, 0, 0, 0)))
    assert not torch.equal(flat.float(), want[1:2, :e])


def _operands(m, k, n, trans=False, seed=3):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((m, k), generator=gen) * 2).bfloat16()
    w = torch.randn((n, k) if trans else (k, n), generator=gen).bfloat16()
    return x, w, (w.T if trans else w)


KW = dict(bits=8, scheme="dither", counter=7, seed=11)


@pytest.mark.parametrize("trans", [False, True], ids=["row", "trans"])
def test_kernel6_plain_sharded_blocks_reassemble_the_product(trans):
    m, k, n = 24, 40, 36
    x, w, wv = _operands(m, k, n, trans)
    ax, aw = ref.policy_absmax(x), ref.policy_absmax(w)
    full = ref.dither_matmul_scaled_ref(x, wv, aw, **KW)
    # row blocks (data shards)
    rows = [dm.dither_matmul_sharded(
        x[i:i + 12].contiguous(), wv, ax, aw,
        block=ref.MatmulBlock(m, k, n, m0=i), **KW) for i in (0, 12)]
    assert torch.equal(torch.cat(rows), full)
    # column blocks (column-parallel weights)
    cols = []
    for j in (0, 18):
        wc = w[j:j + 18].T if trans else w[:, j:j + 18].contiguous()
        cols.append(dm.dither_matmul_sharded(
            x, wc, ax, aw, block=ref.MatmulBlock(m, k, n, n0=j), **KW))
    assert torch.equal(torch.cat(cols, 1), full)
    # K blocks (row-parallel): exact integer partials, one epilogue
    parts = []
    for k0 in (0, 20):
        wk = (w[:, k0:k0 + 20].contiguous().T if trans
              else w[k0:k0 + 20].contiguous())
        parts.append(dm.dither_matmul_sharded(
            x[:, k0:k0 + 20].contiguous(), wk, ax, aw,
            block=ref.MatmulBlock(m, k, n, k0=k0), partials=True, **KW))
    acc, rowsum, colsum = (parts[0][i] + parts[1][i] for i in range(3))
    assert acc.dtype == rowsum.dtype == colsum.dtype == torch.int32
    got = dm.dither_matmul_epilogue(acc, rowsum, colsum, ax, aw, bits=8, k=k)
    assert torch.equal(got, full)
    # a token shard of the sequence split: batch 4 × S 6, rows 3..5
    b_, s_ = 4, 6
    xs = x.reshape(b_, s_, k)[:, 3:].reshape(-1, k).contiguous()
    seg = dm.dither_matmul_sharded(
        xs, wv, ax, aw, block=ref.MatmulBlock(m, k, n, m0=3, seg=3,
                                              seg_stride=s_), **KW)
    assert torch.equal(seg, full.reshape(b_, s_, n)[:, 3:].reshape(-1, n))


def test_kernel6_plain_forms_unchanged_at_the_defaults():
    """The whole product as one block (offsets 0, global = local, absmax
    computed) is today's result bit for bit, in f32 and in the policy's
    scaled form."""
    m, k, n = 17, 33, 29
    x, w, _ = _operands(m, k, n)
    a, b = x.float() / 4, w.float() / 4
    for rng in ((0.0, 1.0), (-1.0, 1.0)):
        kw = dict(bits=6, scheme="dither", a_range=rng, b_range=rng,
                  counter=2, seed=4)
        assert torch.equal(ref.dither_matmul_ref(a, b, **kw),
                           ref.dither_matmul_ref(
                               a, b, block=ref.MatmulBlock(m, k, n), **kw))
    aw = ref.policy_absmax(w)
    assert torch.equal(
        ref.dither_matmul_scaled_ref(x, w, aw, **KW),
        ref.dither_matmul_scaled_ref(x, w, aw, x_absmax=ref.policy_absmax(x),
                                     block=ref.MatmulBlock(m, k, n), **KW))


# ------------------------------------------------------------ elastic


@pytest.mark.parametrize("shape", [(2, 1), (1, 1)], ids=["2x1", "1x1"])
def test_checkpoint_from_2x2_restores_on_another_mesh(runs, shape):
    assert all(r["train-elastic-save"]["saved"] for r in runs["save"])
    res = [r["train-elastic-restore"] for r in runs["restore"][shape]]
    for r in res:
        assert r["blocks_equal"], (shape, r)
        assert r["counter"] == 1 and r["step"] == 1
    if shape == (1, 1):
        assert res[0]["whole"]
    assert len({r["loss"] for r in res}) == 1


# -------------------------------------------------------------- limits


def test_limits_raise(runs):
    out = runs["save"][0]["train-limits"]
    assert out["straddle"] is not None and "straddle" in out["straddle"]
    assert out["return_kv"] is not None and "return_kv" in out["return_kv"]
    assert out["batch"] is not None and "data shards" in out["batch"]
    assert out["microbatch"] is not None and "microbatches" in \
        out["microbatch"]


# ----------------------------------------------------------- batch_spec


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_spec_matches_reference(arch):
    want = ref_registry.batch_spec(ref_get_config(arch), 4, 32)
    got = registry.batch_spec(get_config(arch), 4, 32)
    assert sorted(got) == sorted(want)
    for k, (shape, dtype) in got.items():
        assert shape == tuple(want[k].shape), (arch, k)
        assert str(dtype).split(".")[-1] == str(want[k].dtype), (arch, k)


# ------------------------------------------------------------- launcher


def _run(args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


TRAIN = ["-m", "repro_torch.launch.train", "--arch", "smollm_135m",
         "--reduced", "--device", "cpu", "--steps", "2", "--batch", "4",
         "--seq", "16"]


def _first_loss(stdout):
    done = [ln for ln in stdout.splitlines() if ln.startswith("done:")]
    assert len(done) == 1, stdout
    return float(done[0].split("loss ")[1].split(" ->")[0])


def test_torchrun_trains_data_parallel_on_the_cpu():
    """Two ranks under gloo train on the world size × 1 mesh: only rank 0
    prints, and the first step's loss is the single-device launcher's
    within the no-policy tolerance (the mean of the two shards' means)."""
    single = _run(TRAIN)
    assert single.returncode == 0, single.stderr[-3000:]
    out = _run(["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2"] + TRAIN)
    assert out.returncode == 0, out.stderr[-3000:]
    assert sum(ln.startswith("step ") for ln in out.stdout.splitlines()) == 1
    assert abs(_first_loss(out.stdout) - _first_loss(single.stdout)) \
        <= TOL[False]["loss"]


# --------------------------------------------------------------- layout


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)],
                         ids=["2x1", "1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_layout_matches_reference(arch, shape):
    """``train_param_specs`` is the reference's ``param_specs`` at every
    training mesh; a rank's local shapes widen back to the global ones
    (``interop.global_shapes``); the blocks ``local_block`` cuts sit where
    ``shard_view`` says, and tile every sharded leaf."""
    import test_torch_sharding as ts
    from repro.dist import sharding as ref_shd
    from repro_torch import interop, tree
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.sharding import MeshShape

    cfg = get_config(arch)
    shapes = ts._param_shapes(arch)
    mine, theirs = ts._meshes(("data", "model"), shape)
    ts._assert_same(shd.train_param_specs(shapes, cfg, mine),
                    ref_shd.param_specs(shapes, cfg, theirs))
    if arch != "smollm_135m":        # one real tree: the reduced config's
        return
    pcfg = get_config(arch).reduced()
    params = registry.init_model(pcfg, seed=0, device="cpu")
    mesh = MeshShape(("data", "model"), shape)
    specs = shd.spec_leaves(shd.train_param_specs(params, pcfg, mesh))
    sizes = {"data": shape[0], "model": shape[1]}
    for m in range(shape[1]):
        coords = {"data": 0, "model": m}
        local = interop.shard_train_state(
            {"params": params, "opt": {"m": params, "v": params, "step": 0},
             "counter": 0}, pcfg, coords, mesh)["params"]
        wide = tree.leaves(interop.global_shapes(local, pcfg, mesh))
        for g, l_, w, spec in zip(tree.leaves(params), tree.leaves(local),
                                  wide, specs):
            assert tuple(w.shape) == tuple(g.shape)
            view = shd.shard_view(g.shape, spec, sizes, coords)
            sl = tuple(slice(o, o + n) for o, n in zip(view.offset,
                                                       l_.shape))
            assert torch.equal(g[sl], l_)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_train_state_on_mesh_is_the_shard_of_the_global(arch, shape):
    """``init_train_state(mesh=, coords=)``, which never holds the global
    moments, is ``shard_train_state`` of the global state bit for bit at
    every coordinate: params, m, v, step and counter."""
    from repro_torch import interop, tree
    from repro_torch.dist.sharding import MeshShape
    from repro_torch.train import trainer

    cfg = get_config(arch).reduced()
    mesh = MeshShape(("data", "model"), shape)
    glob = trainer.init_train_state(cfg, seed=3, device="cpu")
    for d in range(shape[0]):
        for m in range(shape[1]):
            coords = {"data": d, "model": m}
            want = interop.shard_train_state(glob, cfg, coords, mesh)
            got = trainer.init_train_state(cfg, seed=3, device="cpu",
                                           mesh=mesh, coords=coords)
            pairs = list(zip(tree.leaves(got), tree.leaves(want)))
            assert len(pairs) == len(tree.leaves(want))
            for g, w in pairs:
                assert g.dtype == w.dtype and g.shape == w.shape
                assert torch.equal(g, w)
