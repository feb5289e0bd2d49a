"""The port's quantisation policy (``repro_torch.numerics.policy``) against
the reference's ``repro.numerics.policy``, op by op and through the model,
at ``smollm_135m.reduced()``; inputs from numpy seeds.

Tolerances, each for its reason:

* ``_fake_quant`` (the unfused backend's grid, the reference's ``"jnp"``
  and the port's ``"torch"``) and ``dense`` on the fused backend (the
  port's ``torch-ref`` plain dither matmul against the reference's
  ``xla-ref``) are **bitwise**, in f32 and in bf16: every step keeps the
  reference's dtype, and the integer product is exact.
* ``dense`` on the unfused backend multiplies the fake-quantised operands
  with a library matmul whose f32 summation order differs: within
  ``1e-6`` (f32) and one bf16 ulp (bf16) of the reference.
* **Model logits within ``POLICY_LOGIT_TOL`` = 2⁻³ (mean 2⁻⁶)** of the
  jitted reference, against 2⁻⁶ without a policy
  (``tests/test_torch_model.py``).  The quantiser's range is the absmax of
  the whole operand, so one bf16 ulp of difference in its largest element
  (XLA's excess precision, transcendental ulps) moves the grid of every
  element: the reference itself, fed embeddings changed by one ulp in 1 %
  of their entries, moves its dither-policy logits by 0.035 (0.008 on
  average), against 0.008 (0.002) without a policy.  Measured port vs
  reference: at most 0.082, 0.0118 on average over a prefill and three
  decode steps, every scheme, both backends, bf16 and int8 KV.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import registry as ref_registry
from repro.numerics import policy as ref_policy
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.models import registry
from repro_torch.numerics import policy
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = ref_get_config("smollm_135m").reduced()
PCFG = get_config("smollm_135m").reduced()
PARAMS = ref_registry.init_model(jax.random.PRNGKey(0), CFG)
TORCH_PARAMS = params_from_numpy(jax.tree.map(np.asarray, PARAMS), "cpu")
POLICY_LOGIT_TOL, POLICY_MEAN_TOL = 2.0 ** -3, 2.0 ** -6
SCHEMES = ["dither", "stochastic", "deterministic"]
BACKENDS = [("xla-ref", "torch-ref"), ("jnp", "torch")]     # (ref, port)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(rng, shape, dtype, scale=1.0):
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()
    return jnp.asarray(a), torch.from_numpy(a)


def _pols(scheme, ref_backend, port_backend, **kw):
    return (ref_policy.QuantPolicy(scheme=scheme, backend=ref_backend,
                                   **kw).resolved(),
            policy.QuantPolicy(scheme=scheme, backend=port_backend,
                               **kw).resolved())


def test_policy_fields_are_the_references():
    """Same fields and defaults, but for the unfused backend's name
    (``"torch"`` for the reference's ``"jnp"``); ``enabled``,
    ``with_seed`` and ``resolved`` behave alike."""
    ref_f = {f.name: f.default for f in
             dataclasses.fields(ref_policy.QuantPolicy)}
    port_f = {f.name: f.default for f in dataclasses.fields(policy.QuantPolicy)}
    assert ref_f.pop("backend") == "jnp" and port_f.pop("backend") == "torch"
    assert port_f == ref_f
    p = policy.QuantPolicy()
    assert not p.enabled and policy.QuantPolicy(scheme="dither").enabled
    assert p.with_seed(9).seed == 9 and p.resolved() == p
    assert policy.QuantPolicy(backend="auto").resolved("cpu").backend == \
        "torch-ref"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_fake_quant_bitwise(scheme, dtype):
    """``_fake_quant`` of activation- and weight-like tensors, bits 8 and
    4, at counters past 2^16: the reference's values bit for bit."""
    rng = np.random.default_rng(SCHEMES.index(scheme))
    for shape, scale, bits in (((24, 128), 1.0, 8), ((128, 96), 0.05, 4)):
        jx, tx = _pair(rng, shape, dtype, scale)
        rp, pp = _pols(scheme, "jnp", "torch", bits=bits, n_pulses=16)
        for counter, seed in ((0, 1), (70001, 6)):
            want = ref_policy._fake_quant(jx, rp, jnp.float32(counter), seed)
            got = policy._fake_quant(tx, pp, float(counter), seed)
            assert got.dtype == tx.dtype
            np.testing.assert_array_equal(_f32(got).view(np.uint32),
                                          _f32(want).view(np.uint32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_dense_fused_bitwise(scheme, dtype):
    """``dense`` through the fused dispatch matmul (port ``torch-ref``,
    reference ``xla-ref``) on 2-D and 3-D activations — a decode step's
    (B, 1, d) and a prefill's (B, S, d) — with the serve path's seeds:
    bit for bit, in the operands' dtype."""
    rng = np.random.default_rng(10 + SCHEMES.index(scheme))
    rp, pp = _pols(scheme, "xla-ref", "torch-ref")
    for xshape, wshape in (((8, 128), (128, 384)), ((2, 1, 128), (128, 64)),
                           ((3, 16, 256), (256, 128))):
        jx, tx = _pair(rng, xshape, dtype)
        jw, tw = _pair(rng, wshape, dtype, 0.05)
        for counter, seed in ((0, 1), (12, 9)):
            want = ref_policy.dense(jx, jw, rp, counter=counter, seed=seed)
            got = policy.dense(tx, tw, pp, counter=counter, seed=seed)
            assert got.dtype == tx.dtype and got.shape == tuple(want.shape)
            np.testing.assert_array_equal(_f32(got).view(np.uint32),
                                          _f32(want).view(np.uint32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_dense_unfused_within_matmul_rounding(scheme, dtype):
    """``dense`` on the unfused backend: the fake-quantised operands are
    bitwise (``test_fake_quant_bitwise``), the library matmul sums in
    another order, so the product is within 1e-6 (f32) or one bf16 ulp."""
    rng = np.random.default_rng(20 + SCHEMES.index(scheme))
    rp, pp = _pols(scheme, "jnp", "torch")
    jx, tx = _pair(rng, (8, 128), dtype)
    jw, tw = _pair(rng, (128, 384), dtype, 0.05)
    want = _f32(ref_policy.dense(jx, jw, rp, counter=3, seed=2))
    got = _f32(policy.dense(tx, tw, pp, counter=3, seed=2))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("ref_backend,port_backend", BACKENDS)
def test_qmatmul_ste_gradients(ref_backend, port_backend):
    """The straight-through backward through ``torch.autograd``: the
    gradients of a scalar loss of ``qmatmul`` are the full-precision ones,
    as ``jax.grad`` gives them for the reference; the forward values agree
    (bitwise on the fused backend)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 32)).astype(np.float32)
    w = rng.normal(size=(32, 5)).astype(np.float32)
    g = rng.normal(size=(6, 5)).astype(np.float32)
    rp, pp = _pols("dither", ref_backend, port_backend)

    def loss(x, w):
        return jnp.sum(ref_policy.qmatmul(x, w, rp, 3, jnp.float32(2)) * g)

    gx_ref, gw_ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                    jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = policy.qmatmul(tx, tw, pp, 3, 2.0)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), g @ w.T, rtol=1e-5,
                               atol=1e-5)
    want = np.asarray(ref_policy.qmatmul(jnp.asarray(x), jnp.asarray(w), rp,
                                         3, jnp.float32(2)))
    if port_backend == "torch-ref":
        np.testing.assert_array_equal(out.detach().numpy(), want)
    else:
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-6)


def test_fake_quant_helper_and_disabled_policy():
    """``fake_quant`` rounds with a straight-through (identity) gradient;
    a disabled or absent policy leaves ``fake_quant`` and ``dense`` plain."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.uniform(size=(8, 8)).astype(np.float32))
    pol = policy.QuantPolicy(scheme="dither", bits=6)
    a, b = policy.fake_quant(x, pol, counter=0), policy.fake_quant(x, pol,
                                                                   counter=1)
    assert not torch.allclose(a, b) and (a - x).abs().max() < 0.05
    np.testing.assert_array_equal(
        a.numpy(), np.asarray(ref_policy.fake_quant(
            jnp.asarray(x.numpy()), ref_policy.QuantPolicy(scheme="dither",
                                                           bits=6))))
    xg = x.clone().requires_grad_()
    policy.fake_quant(xg, pol, counter=3).sum().backward()
    assert torch.equal(xg.grad, torch.ones_like(x))
    w = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    for off in (None, policy.QuantPolicy()):
        assert policy.fake_quant(x, off) is x
        assert torch.equal(policy.dense(x, w, off), x @ w)
    with pytest.raises(ValueError, match="unknown rounding scheme"):
        policy.dense(x, w, policy.QuantPolicy(scheme="bogus",
                                              backend="torch-ref"))


@pytest.mark.parametrize("backend", ["torch", "torch-ref"])
def test_dither_policy_unbiased_over_counters(backend):
    """Averaging the quantised matmul over a pulse period recovers x @ w
    (the reference's ``tests/test_policy.py`` claim), on both backends."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(size=(16, 32)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-1, 1, size=(32, 8)).astype(np.float32))
    pol = policy.QuantPolicy(scheme="dither", bits=4, n_pulses=16,
                             backend=backend)
    outs = torch.stack([policy.qmatmul(x, w, pol, 0, float(c))
                        for c in range(64)])
    exact = x @ w
    err = float((outs.mean(0) - exact).abs().max() / exact.abs().max())
    assert err < 0.05, err


# ---------------------------------------------------------------------------
# through the model
# ---------------------------------------------------------------------------


def _inputs(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, CFG.vocab_size, size=(3, 16)).astype(np.int32)
    return toks, np.array([16, 9, 5], np.int32), np.array([0, 1000, 2000],
                                                          np.int32)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("ref_backend,port_backend", BACKENDS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_prefill_and_decode_logits_under_policy(scheme, ref_backend,
                                                port_backend, kv_quant):
    """A batched prefill (counter 5) and three decode steps (counters 6–8),
    teacher-forced with the reference's greedy tokens, against the jitted
    reference: logits within ``POLICY_LOGIT_TOL``, their mean error within
    ``POLICY_MEAN_TOL``."""
    toks, lens, off = _inputs(1)
    rp, pp = _pols(scheme, ref_backend, port_backend)
    prefill = jax.jit(lambda p, t, n, o, c: ref_registry.apply_prefill(
        p, CFG, t, n, 32, policy=rp, counter=c, kv_quant=kv_quant,
        kv_offset=o))
    decode = jax.jit(lambda p, t, ca, o, c: ref_registry.apply_decode(
        p, CFG, t, ca, policy=rp, counter=c, kv_offset=o))
    jl, jc = prefill(PARAMS, jnp.asarray(toks), jnp.asarray(lens),
                     jnp.asarray(off), 5)
    tl, tc = registry.apply_prefill(
        TORCH_PARAMS, PCFG, torch.from_numpy(toks).long(),
        torch.from_numpy(lens), 32, policy=pp, counter=5, kv_quant=kv_quant,
        kv_offset=torch.from_numpy(off))
    errs = [np.abs(tl.numpy() - np.asarray(jl))]
    cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for step in range(3):
        jl, jc = decode(PARAMS, jnp.asarray(cur), jc, jnp.asarray(off),
                        6 + step)
        tl, tc = registry.apply_decode(
            TORCH_PARAMS, PCFG, torch.from_numpy(cur), tc, policy=pp,
            counter=6 + step, kv_offset=torch.from_numpy(off))
        assert tl.shape == (3, CFG.vocab_size) and tl.dtype == torch.float32
        errs.append(np.abs(tl.numpy() - np.asarray(jl)))
        cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
    assert max(e.max() for e in errs) <= POLICY_LOGIT_TOL, [e.max()
                                                           for e in errs]
    assert max(e.mean() for e in errs) <= POLICY_MEAN_TOL, [e.mean()
                                                            for e in errs]


class _Counting:
    """Counts the calls of ``dispatch.matmul`` (the fused product)."""

    def __init__(self, monkeypatch):
        self.n = 0
        original = dispatch.matmul

        def counted(*args, **kw):
            self.n += 1
            return original(*args, **kw)

        monkeypatch.setattr(dispatch, "matmul", counted)


def test_every_dense_product_runs_under_the_policy(monkeypatch):
    """Seven quantised products per layer plus the LM head in a ring
    prefill, a paged prefill and a decode step (2 layers: 15 each) — the
    LM head included, as in the reference (``_logits`` once dropped the
    policy there) — and the head's quantised output is what ``dense``
    gives under the policy with seed 9."""
    from repro_torch.models import layers, transformer

    count = _Counting(monkeypatch)
    toks, lens, off = _inputs(2)
    pol = policy.QuantPolicy(scheme="dither", backend="torch-ref")
    per_forward = 7 * PCFG.n_layers + 1
    logits, cache = registry.apply_prefill(
        TORCH_PARAMS, PCFG, torch.from_numpy(toks).long(),
        torch.from_numpy(lens), 32, policy=pol, counter=1,
        kv_offset=torch.from_numpy(off))
    assert count.n == per_forward
    x = torch.randn((3, 1, PCFG.d_model),
                    generator=torch.Generator().manual_seed(0)).bfloat16()
    head = TORCH_PARAMS["embed"].T
    want = policy.dense(layers.rms_norm(x, TORCH_PARAMS["final_norm"],
                                        PCFG.norm_eps), head, pol, 4,
                        seed=9).float()
    got = transformer._logits(TORCH_PARAMS, PCFG, x, pol, 4)
    assert torch.equal(got, want)
    count.n = 0
    registry.apply_decode(TORCH_PARAMS, PCFG, torch.tensor([3, 4, 5]), cache,
                          policy=pol, counter=2,
                          kv_offset=torch.from_numpy(off))
    assert count.n == per_forward
    count.n = 0
    pc = registry.make_cache(TORCH_PARAMS, PCFG, 3, 32, kv_layout="paged",
                             block_size=8, device="cpu")
    bt = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    registry.apply_prefill_paged(
        TORCH_PARAMS, PCFG, torch.from_numpy(toks).long(),
        torch.from_numpy(lens), torch.zeros(3, dtype=torch.int32), bt, pc,
        policy=pol, counter=1)
    assert count.n == per_forward
