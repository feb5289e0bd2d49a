"""The port's MoE FFN (``repro_torch/models/moe.py``) against the
reference's ``models/moe.py`` and against a dense brute force.

Tolerances, each for its reason:

* bf16, the serving dtype: within 2 bf16 ulps.  Both run the same ops
  in the same dtypes (the reference's ``moe_ffn`` called op by op), the
  expert products multiply bf16 in f32 and round once on both sides, but
  the f32 sums run in another order, so a rounding may flip: 2 outputs
  of 12 × 4,096 were one ulp off over three seeds, the rest equal.
* f32: the router's gates within ``GATE_TOL`` = 1e-6 and the expert
  choice equal; the fixture's every gap between the k-th and the
  (k+1)-th routing probability clears ``MARGIN`` = 1e-5 (below it a
  summation-order ulp may swap two experts: reseed); the output within
  ``F32_TOL`` = 1e-5 (f32 sums in another order; measured ≤ 8e-7).
* Under the dither policy the fake-quantised expert operands (seeds
  11–15) are the reference's bit for bit; on these inputs the output
  (the reference jitted as written, ``tests/_torch_zoo.py``) is bitwise,
  and so is the shared expert's test.
* Dense brute force (f32, numpy): 2e-3 absolute, as
  ``tests/test_moe.py`` holds the reference (f32 matmuls in numpy's
  order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from _torch_zoo import MOE, model, ref_jit, to_jax
from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.numerics.policy import QuantPolicy as RefPolicy
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.numerics.policy import QuantPolicy

GATE_TOL, MARGIN, F32_TOL = 1e-6, 1e-5, 1e-5


def _assert_bf16_ulps(got, want, n=2):
    """|got - want| ≤ n bf16 ulps of the larger magnitude."""
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want).astype(np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= n * ulp), np.abs(got - want).max()


def _moe_params(arch, dtype):
    """Layer 0's MoE params of the zoo model (port, reference), in
    ``dtype`` (the f32 router stays f32)."""
    _, pcfg, _, tp = model(arch)
    p = tree.tree_map(lambda t: t[0], tp["blocks"][0]["moe"])
    if dtype == torch.float32:
        p = tree.tree_map(lambda t: t.float(), p)
    return p, tree.unflatten(p, [to_jax(t) for t in tree.leaves(p)])


def _x(cfg, dtype, shape=(2, 16), seed=0):
    x = np.random.default_rng(seed).normal(
        size=shape + (cfg.d_model,)).astype(np.float32)
    t = torch.from_numpy(x).to(dtype)
    return t, to_jax(t)


def _cfgs(arch, cf):
    ref_cfg, pcfg, _, _ = model(arch)
    return (dataclasses.replace(ref_cfg, capacity_factor=cf),
            dataclasses.replace(pcfg, capacity_factor=cf))


@pytest.mark.parametrize("cf", [0.05, 8.0], ids=["drops", "no-drops"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_bf16(arch, cf):
    """bf16 in, bf16 out, the reference's to 2 ulps, with capacity drops
    (cf 0.05: most assignments drop) and without (cf 8)."""
    ref_cfg, pcfg = _cfgs(arch, cf)
    tp, jp = _moe_params(arch, torch.bfloat16)
    tx, jx = _x(pcfg, torch.bfloat16)
    got = moe.moe_ffn(tp, pcfg, tx)
    want = np.asarray(ref_moe.moe_ffn(jp, ref_cfg, jx))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _assert_bf16_ulps(got, want)


@pytest.mark.parametrize("cf", [0.05, 8.0], ids=["drops", "no-drops"])
@pytest.mark.parametrize("arch", MOE)
def test_router_and_output_f32(arch, cf):
    """f32: the gates and the expert choice of every token whose top-k
    margin clears ``MARGIN``, each assignment's capacity slot and
    validity (the reference's cumulative count), and the output."""
    ref_cfg, pcfg = _cfgs(arch, cf)
    tp, jp = _moe_params(arch, torch.float32)
    tx, jx = _x(pcfg, torch.float32, seed=1)
    k, t = pcfg.n_experts_active, tx.shape[0] * tx.shape[1]
    gate, expert, slot, valid = moe.route(tp, pcfg, tx.reshape(t, -1))

    # the reference's routing lines (models/moe.py, dp = 1)
    logits = jnp.matmul(jx.reshape(t, -1).astype(jnp.float32), jp["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    rgate, ridx = jax.lax.top_k(probs, k)
    rgate = np.asarray(rgate / jnp.sum(rgate, axis=-1, keepdims=True))
    ridx = np.asarray(ridx)
    top = -np.sort(-np.asarray(probs), axis=-1)
    margin = top[:, k - 1] - top[:, k]
    assert margin.min() >= MARGIN, (
        f"near-tied routing (gap {margin.min():.2e}): reseed the fixture")
    assert np.array_equal(expert.reshape(t, k).numpy(), ridx)
    np.testing.assert_allclose(gate.numpy(), rgate, atol=GATE_TOL, rtol=0)
    oh = np.eye(pcfg.n_experts, dtype=np.int64)[ridx.reshape(-1)]
    rank = np.sum((np.cumsum(oh, axis=0) - 1) * oh, axis=-1)
    cap = ref_moe.moe_capacity(t, ref_cfg)
    assert np.array_equal(valid.numpy(), rank < cap)
    assert np.array_equal(slot.numpy(), np.where(rank < cap, rank, 0))
    assert (~valid).any() == (cf < 1)
    np.testing.assert_allclose(
        moe.moe_ffn(tp, pcfg, tx).numpy(),
        np.asarray(ref_moe.moe_ffn(jp, ref_cfg, jx)), atol=F32_TOL, rtol=0)


def test_moe_ffn_under_dither_policy_bitwise():
    """Under the dither policy the routed experts' weights, dispatch
    buffer and hidden activations are fake-quantised with seeds 11–15,
    and qwen2-moe's shared expert goes through ``layers.mlp``'s policy
    products, exactly as the reference does."""
    ref_cfg, pcfg = _cfgs("qwen2_moe_a2_7b", 1.25)
    tp, jp = _moe_params("qwen2_moe_a2_7b", torch.bfloat16)
    tx, jx = _x(pcfg, torch.bfloat16, seed=2)
    got = moe.moe_ffn(tp, pcfg, tx, QuantPolicy(scheme="dither"), counter=3)
    want = np.asarray(ref_jit(ref_moe.moe_ffn, static_argnums=(1, 3))(
        jp, ref_cfg, jx, RefPolicy(scheme="dither"), 3))
    assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def test_capacity_formula():
    ref_cfg, pcfg, _, _ = model("qwen2_moe_a2_7b")
    for full in (False, True):
        rc = ref_get_config("qwen2_moe_a2_7b") if full else ref_cfg
        pc = get_config("qwen2_moe_a2_7b") if full else pcfg
        for n in (1, 7, 8, 64, 2048, 4096):
            for cf in (0.05, 1.25, 8.0):
                assert moe.moe_capacity(n, dataclasses.replace(
                    pc, capacity_factor=cf)) == ref_moe.moe_capacity(
                    n, dataclasses.replace(rc, capacity_factor=cf))
    full = get_config("qwen2_moe_a2_7b")
    assert moe.moe_capacity(8, full) == 1       # ⌈8·4·1.25/60⌉: decode, B 8
    assert moe.moe_capacity(64, dataclasses.replace(
        full, n_experts=8, n_experts_active=2)) == 20


def test_shared_expert_is_layers_mlp():
    """qwen2-moe's shared expert: the output less the routed experts' is
    ``layers.mlp`` of the shared SwiGLU on the same tokens, bit for bit,
    and the reference agrees (bitwise bf16)."""
    from repro_torch.models import layers

    ref_cfg, pcfg = _cfgs("qwen2_moe_a2_7b", 1.25)
    tp, jp = _moe_params("qwen2_moe_a2_7b", torch.bfloat16)
    tx, jx = _x(pcfg, torch.bfloat16, seed=3)
    routed = moe.moe_ffn({k: v for k, v in tp.items() if k != "shared"},
                         pcfg, tx)
    shared = layers.mlp(tp["shared"], tx.reshape(-1, pcfg.d_model))
    assert torch.equal(moe.moe_ffn(tp, pcfg, tx),
                       routed + shared.reshape(tx.shape))
    want = np.asarray(ref_moe.moe_ffn(jp, ref_cfg, jx))
    assert np.array_equal(moe.moe_ffn(tp, pcfg, tx).view(torch.int16).numpy(),
                          want.view(np.int16))


def _brute_force(p, cfg, x):
    """Every token through its top-k experts in numpy f32, assignments past
    an expert's capacity (counted over the flattened (token, k) order)
    dropped — the semantics, written plainly."""
    b, s, d = x.shape
    t, k = b * s, cfg.n_experts_active
    xf = x.reshape(t, d).numpy().astype(np.float64)
    w = {n: p[n].numpy().astype(np.float64) for n in ("router", "wg", "wu",
                                                      "wd")}
    logits = xf @ w["router"]
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    cap = moe.moe_capacity(t, cfg)
    used = np.zeros(cfg.n_experts, np.int64)
    out = np.zeros((t, d))
    for ti in range(t):
        top = np.argsort(-probs[ti], kind="stable")[:k]
        gates = probs[ti][top] / probs[ti][top].sum()
        for e_i, g in zip(top, gates):
            used[e_i] += 1
            if used[e_i] > cap:
                continue
            hg, hu = xf[ti] @ w["wg"][e_i], xf[ti] @ w["wu"][e_i]
            out[ti] += g * (((hg / (1 + np.exp(-hg))) * hu) @ w["wd"][e_i])
    return out.reshape(b, s, d)


@pytest.mark.parametrize("cf", [0.05, 8.0], ids=["drops", "no-drops"])
def test_moe_matches_dense_brute_force(cf):
    """The scatter-based dispatch against every token run through its
    experts one by one (``tests/test_moe.py``'s check of the reference),
    here also with capacity drops."""
    _, pcfg = _cfgs("granite_moe_1b_a400m", cf)
    tp, _ = _moe_params("granite_moe_1b_a400m", torch.float32)
    tx, _ = _x(pcfg, torch.float32, shape=(2, 6), seed=4)
    got = moe.moe_ffn(tp, pcfg, tx).numpy()
    want = _brute_force(tp, pcfg, tx)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    if cf < 1:
        assert (np.abs(want).sum(-1) == 0).any()     # some tokens fully drop
