"""The port's optimiser, schedules and gradient compression
(``repro_torch.optim``) against the reference's ``repro.optim`` on the
same inputs (numpy seeds).

Tolerances, each for its reason:

* Schedules: 2 f32 ulps (``2.4e-7``) of the value and of the peak: the
  same f32 ops in the same order, but ``cos`` and ``pow`` of two
  libraries may differ by an ulp, and ``1 + cos`` near its zero keeps
  that ulp of 1 (measured: 5.9e-7 relative at a value 1e-3 of the
  peak).
* AdamW: moments ``m`` and ``v`` within 4 f32 ulps of the value and of
  the leaf's largest magnitude (XLA may fuse a product and a sum into one
  FMA, ``pow`` of the bias correction may differ by an ulp, and
  ``b1·m + (1 − b1)·g`` cancels), the global norm within 1e-6 relative
  (sums in another order); new f32 params as the moments, new bf16
  params within one bf16 ulp (an f32 ulp before the rounding can move
  it), and equal in at least 99 % of entries (measured: all).
* ``compress_grads``: bit for bit — the per-leaf seeds are the same
  ``hash()`` of the same path strings in one process, and the quantiser
  is bitwise the reference's (``tests/test_torch_policy.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.numerics.policy import QuantPolicy as RefPolicy
from repro.optim import adamw as ref_adamw
from repro.optim import grad_compress as ref_gc
from repro.optim import schedules as ref_sched
from repro_torch import tree
from repro_torch.numerics.policy import QuantPolicy
from repro_torch.optim import adamw, grad_compress, schedules

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

STEPS = np.arange(0, 130, dtype=np.int32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("name,args", [
    ("cosine_schedule", (3e-4, 10, 100)),
    ("cosine_schedule", (1e-3, 0, 50, 0.0)),
    ("wsd_schedule", (3e-4, 10, 40, 50)),
    ("wsd_schedule", (1e-2, 5, 0, 7, 0.1)),
])
def test_schedules_match_reference(name, args):
    want = getattr(ref_sched, name)(*args)(jnp.asarray(STEPS))
    got = getattr(schedules, name)(*args)(torch.from_numpy(STEPS))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), np.asarray(want), rtol=2.4e-7,
                               atol=2.4e-7 * args[0])


def test_linear_warmup_matches_reference():
    want = ref_sched.linear_warmup(jnp.asarray(STEPS), 16, 3e-4)
    got = schedules.linear_warmup(torch.from_numpy(STEPS), 16, 3e-4)
    np.testing.assert_allclose(_f32(got), np.asarray(want), rtol=2.4e-7)


def _tree(rng, scale=1.0):
    """A params-like tree: stacked bf16 matrices, a bf16 vector, an f32
    matrix, nested in dicts and a list."""
    def a(shape, dtype):
        return (rng.normal(size=shape) * scale).astype(np.float32), dtype
    return {"blocks": [{"w": a((2, 8, 16), "bf16"), "g": a((2, 8), "bf16")}],
            "embed": a((32, 8), "bf16"), "norm": a((8,), "bf16"),
            "head": a((8, 32), "f32")}


def _to_jax(t):
    return jax.tree.map(lambda v: jnp.asarray(
        v[0], jnp.bfloat16 if v[1] == "bf16" else jnp.float32), t,
        is_leaf=lambda v: isinstance(v, tuple))


def _to_torch(t):
    if isinstance(t, dict):
        return {k: _to_torch(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_to_torch(v) for v in t]
    return torch.from_numpy(t[0]).to(
        torch.bfloat16 if t[1] == "bf16" else torch.float32)


@pytest.mark.parametrize("clip,grad_scale", [(1.0, 1.0), (1.0, 100.0),
                                              (0.0, 100.0)])
def test_adamw_matches_reference(clip, grad_scale):
    """Three AdamW steps (with and without global-norm clipping, decay on
    matrices only) against the reference's ``apply_updates``."""
    rng = np.random.default_rng(7)
    p_np = _tree(rng)
    ref_opt = ref_adamw.AdamW(lr=ref_sched.cosine_schedule(1e-2, 2, 10),
                              grad_clip=clip)
    opt = adamw.AdamW(lr=schedules.cosine_schedule(1e-2, 2, 10),
                      grad_clip=clip)
    jp, tp = _to_jax(p_np), _to_torch(p_np)
    js, ts = ref_adamw.init_opt_state(jp), adamw.init_opt_state(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    ref_update = jax.jit(ref_adamw.apply_updates, static_argnums=0)
    for _ in range(3):
        g_np = _tree(rng, grad_scale)
        jp, js, jm = ref_update(ref_opt, jp, _to_jax(g_np), js)
        tp, ts, tm = adamw.apply_updates(opt, tp, _to_torch(g_np), ts)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=2.4e-7)
        for key in ("m", "v"):
            for g, w in zip(tree.leaves(ts[key]), jax.tree.leaves(js[key])):
                assert g.dtype == torch.float32
                w = np.asarray(w)
                np.testing.assert_allclose(_f32(g), w, rtol=4.8e-7,
                                           atol=4.8e-7 * np.abs(w).max())
        same = total = 0
        for g, w in zip(tree.leaves(tp), jax.tree.leaves(jp)):
            f32 = g.dtype == torch.float32
            g, w = _f32(g), _f32(w)
            if f32:             # as the moments
                np.testing.assert_allclose(g, w, rtol=4.8e-7,
                                           atol=4.8e-7 * np.abs(w).max())
                continue
            mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 1e-30)
            ulp = np.exp2(np.floor(np.log2(mag)) - 7)
            assert np.all(np.abs(g - w) <= ulp)
            same += int(np.sum(g == w))
            total += g.size
        assert same >= 0.99 * total
    assert int(ts["step"]) == int(js["step"]) == 3
    assert tp["head"].dtype == torch.float32
    assert tp["norm"].dtype == torch.bfloat16


def test_adamw_decays_matrices_only_and_clips():
    """With zero gradients only weight decay moves params, and only those
    of two or more dims; a huge gradient is scaled to the clip norm."""
    p = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    opt = adamw.AdamW(lr=0.1, weight_decay=0.5)
    zero = tree.tree_map(torch.zeros_like, p)
    new, state, m = adamw.apply_updates(opt, p, zero, adamw.init_opt_state(p))
    assert torch.allclose(new["w"], torch.full((4, 4), 0.95))
    assert torch.equal(new["b"], p["b"])
    assert float(m["grad_norm"]) == 0.0
    big = {"w": torch.full((4, 4), 1e3), "b": torch.zeros(4)}
    _, state, m = adamw.apply_updates(adamw.AdamW(lr=0.1, grad_clip=1.0), p,
                                      big, adamw.init_opt_state(p))
    assert float(m["grad_norm"]) == pytest.approx(4e3)
    # the clipped gradient (norm 1) enters the first moment
    assert float(state["m"]["w"].norm()) == pytest.approx(0.1, rel=1e-5)
    assert p["w"].eq(1).all()                     # nothing updated in place


def test_adamw_large_leaves_update_in_row_blocks_bit_for_bit(monkeypatch):
    """Leaves above ``CHUNK_ELEMENTS`` update in blocks of rows: params,
    m and v bit for bit the whole-leaf update (bf16 and f32 leaves, a
    transposed gradient, a vector), in the layouts of params and
    moments, and the caller's trees untouched."""
    gen = torch.Generator().manual_seed(3)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype)

    p = {"w": rand(37, 24, dtype=torch.bfloat16), "e": rand(50, 8),
         "b": rand(300)}
    g = {"w": rand(24, 37, dtype=torch.bfloat16).T, "e": rand(50, 8),
         "b": rand(300)}
    state = adamw.init_opt_state(p)
    state["m"] = tree.tree_map(lambda t: torch.randn(
        t.shape, generator=gen), state["m"])
    opt = adamw.AdamW(lr=1e-2)
    want = adamw.apply_updates(opt, p, g, state)
    keep = [t.clone() for t in tree.leaves((p, state))]
    monkeypatch.setattr(adamw, "CHUNK_ELEMENTS", 100)
    assert adamw._rows_a_chunk(p["w"]) == 4
    got = adamw.apply_updates(opt, p, g, state)
    for a, b in zip(tree.leaves(got[:2]), tree.leaves(want[:2])):
        assert a.dtype == b.dtype and a.stride() == b.stride()
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves((p, state)),
                                                 keep))


@pytest.mark.parametrize("scheme", ["dither", "stochastic"])
def test_compress_grads_matches_reference_bitwise(scheme):
    """``compress_grads`` over a params-like tree (f32 and bf16 leaves,
    stacked and nested): every matrix leaf fake-quantised with the seed of
    its path, vectors untouched; the same bits as the reference."""
    rng = np.random.default_rng(3)
    g_np = _tree(rng, 1e-3)
    ref_pol = RefPolicy(scheme=scheme, bits=8)
    pol = QuantPolicy(scheme=scheme, bits=8)
    # eager, as tests/test_torch_policy.py holds ``_fake_quant``: XLA's
    # fusion under jit may round the grid's products differently
    want = ref_gc.compress_grads(_to_jax(g_np), ref_pol, jnp.int32(11))
    got = grad_compress.compress_grads(_to_torch(g_np), pol, 11)
    for (path, g), w, orig in zip(tree.leaves_with_path(got),
                                  jax.tree.leaves(want),
                                  tree.leaves(_to_torch(g_np))):
        assert g.dtype == orig.dtype
        np.testing.assert_array_equal(_f32(g).view(np.uint32),
                                      _f32(w).view(np.uint32))
        if g.dim() < 2:
            assert torch.equal(g, orig)
        else:
            assert not torch.equal(g, orig), path
    assert grad_compress.compress_grads(g_np, None, 0) is g_np
    assert grad_compress.compress_grads(g_np, QuantPolicy(), 0) is g_np


def test_leaf_paths_are_jax_key_paths():
    """The seeds hash ``"/".join(str(k) for k in path)`` of JAX's key
    paths; the port builds the same strings."""
    t = {"b": [{"x": np.zeros(1), "a": np.zeros(1)}], "a": np.zeros(1)}
    want = ["/".join(str(k) for k in p)
            for p, _ in jax.tree_util.tree_leaves_with_path(t)]
    assert [tree.path_str(p) for p, _ in tree.leaves_with_path(t)] == want
    assert want[1] == "['b']/[0]/['a']"
