"""The port's encoder-decoder (``models/encdec.py``, whisper-small at
``.reduced()``: 2 + 2 layers, d 128, 4 heads of 32, 32 frames, vocab 512)
against the reference's on the same weights (the port's init carried
over, ``tests/_torch_zoo.py``): ``layer_norm``, the encoder, the
full-sequence forward with and without the dither policy, the decode
cache's cross-KV, decode steps, the prefill merge, the param tree, and
which products run under the policy.

Tolerances, each for its reason:

* ``layer_norm`` (eager on both sides, each op rounded as written):
  one bf16 ulp — the f32 mean and variance may sum in another order.
* The encoder's output and the cross-KV: one bf16 ulp (measured: equal
  to the reference compiled as written).
* Logits within ``LOGIT_TOL`` = 2⁻⁶ (``tests/test_torch_model.py``;
  measured 2⁻⁸ for the forward); under the dither policy within
  ``POLICY_TOL`` = 2⁻³ (ROADMAP "Findings that set the tolerances": the
  quantiser's tensor-global absmax turns an ulp of difference before it
  into a shifted grid; measured 0.032 for the forward).
* The prefill merge and the param tree: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_zoo import model, ref_jit, to_jax
from repro.configs import get_config as ref_get_config
from repro.models import encdec as ref_encdec
from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro.numerics.policy import QuantPolicy as RefQuantPolicy
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, all_configs, get_config
from repro_torch.interop import cache_from_numpy, params_from_numpy
from repro_torch.models import encdec, layers, registry
from repro_torch.numerics import policy as port_policy
from repro_torch.numerics.policy import QuantPolicy

ARCH = "whisper_small"
LOGIT_TOL = 2.0 ** -6
POLICY_TOL = 2.0 ** -3
B, MAX_LEN = 3, 32
REF_ENCODE = ref_jit(ref_encdec.encode)
REF_FORWARD = ref_jit(ref_registry.apply_model,
                      static_argnames=("remat", "policy"))
REF_CACHE = ref_jit(ref_encdec.init_encdec_cache, static_argnums=(1, 3, 4))
REF_PREFILL = ref_jit(ref_registry.apply_prefill, static_argnums=(1, 4),
                      static_argnames=("kv_quant",))
REF_DECODE = ref_jit(ref_registry.apply_decode)


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_bf16_ulps(got, want, n=1, what=""):
    """|got - want| ≤ n bf16 ulps of the larger magnitude."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, what
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= n * ulp), (what,
                                                   np.abs(got - want).max())


def _frames(cfg, b=B, seed=0):
    """Random frames (B, n_enc_tokens, d) as (jax, torch) bf16 twins."""
    f = np.random.default_rng(seed).normal(
        size=(b, cfg.n_enc_tokens, cfg.d_model)).astype(np.float32)
    return jnp.asarray(f, jnp.bfloat16), torch.from_numpy(f).bfloat16()


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=shape).astype(np.int32)


def test_config_is_the_reference_config():
    """whisper-small and its reduced form equal the reference's; the
    port's ``ARCH_IDS`` are the reference's ten, and ``all_configs`` maps
    each to its config."""
    from repro.configs import ARCH_IDS as REF_IDS
    from repro.configs import all_configs as ref_all

    ref = ref_get_config(ARCH)
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(ref)
    assert dataclasses.asdict(get_config("whisper-small").reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert ARCH_IDS == REF_IDS
    assert {a: dataclasses.asdict(c) for a, c in all_configs().items()} == \
        {a: dataclasses.asdict(c) for a, c in ref_all().items()}


def test_layer_norm_matches_reference():
    """``layers.layer_norm`` against the reference's on bf16 rows of mixed
    scale, at ``cfg.norm_eps`` and at the function's default eps."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(4, 7, 128)) * rng.uniform(0.1, 30, (4, 7, 1))
         ).astype(np.float32) + 3.0
    g = rng.normal(size=(128,)).astype(np.float32)
    b = rng.normal(size=(128,)).astype(np.float32)
    jx, jg, jb = (jnp.asarray(a, jnp.bfloat16) for a in (x, g, b))
    tx, tg, tb = (torch.from_numpy(a).bfloat16() for a in (x, g, b))
    for eps in (get_config(ARCH).norm_eps, 1e-5):
        want = ref_layers.layer_norm(jx, jg, jb, eps)
        got = layers.layer_norm(tx, tg, tb, eps)
        assert got.dtype == torch.bfloat16
        _assert_bf16_ulps(got, want, what=f"eps {eps}")
    assert get_config(ARCH).norm_eps == 1e-6


def test_encode_matches_reference():
    """The encoder (frames + positions, bidirectional pre-LN blocks
    without RoPE, ``enc_norm``): its bf16 output against the
    reference's."""
    cfg, pcfg, params, tp = model(ARCH)
    jf, tf = _frames(cfg)
    want = REF_ENCODE(params, cfg, jf)
    got = encdec.encode(tp, pcfg, tf)
    assert got.dtype == torch.bfloat16
    _assert_bf16_ulps(got, want, what="encode")


@pytest.mark.parametrize("scheme", ["none", "dither"])
def test_forward_matches_reference(scheme):
    """``registry.apply_model`` with ``frames``: full-sequence f32 logits
    over the padded vocab, with and without recomputation; under the
    dither policy the port's plain kernel route (``torch-ref``) against
    the reference's (``xla-ref``)."""
    cfg, pcfg, params, tp = model(ARCH)
    jf, tf = _frames(cfg)
    toks = _tokens(cfg, (B, 12))
    ref_pol = pol = None
    tol = LOGIT_TOL
    if scheme != "none":
        ref_pol = RefQuantPolicy(scheme=scheme, backend="xla-ref")
        pol = QuantPolicy(scheme=scheme, backend="torch-ref")
        tol = POLICY_TOL
    want = np.asarray(REF_FORWARD(params, cfg, {"tokens": jnp.asarray(toks),
                                                "frames": jf},
                                  policy=ref_pol, counter=3, remat=False))
    got = registry.apply_model(tp, pcfg, {"tokens": torch.from_numpy(toks),
                                          "frames": tf},
                               policy=pol, counter=3)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (B, 12, cfg.vocab_padded())
    assert np.abs(got.numpy() - want).max() <= tol
    plain = registry.apply_model(tp, pcfg, {"tokens": torch.from_numpy(toks),
                                            "frames": tf},
                                 policy=pol, counter=3, remat=False)
    assert torch.equal(plain, got)


def test_cache_cross_kv_matches_reference():
    """``registry.make_cache`` with frames: the cross-KV (L, B, T, n_kv,
    hd) against the reference's ``init_encdec_cache``, an empty bf16
    self-KV ring (also with ``kv_quant``: the flag is inert, as the
    reference's) and positions 0; the reference's cache carried over by
    ``interop.cache_from_numpy`` has the port's layout."""
    cfg, pcfg, params, tp = model(ARCH)
    jf, tf = _frames(cfg)
    want = REF_CACHE(params, cfg, jf, B, MAX_LEN)
    for kv_quant in (False, True):
        got = registry.make_cache(tp, pcfg, B, MAX_LEN, tf, kv_quant=kv_quant,
                                  device="cpu")
        assert sorted(got) == ["cross", "layers", "pos", "remainder"]
        shape = (pcfg.n_layers, B, cfg.n_enc_tokens, pcfg.n_kv_heads,
                 pcfg.hd())
        for name in ("k", "v"):
            assert tuple(got["cross"][name].shape) == shape
            assert got["cross"][name].dtype == torch.bfloat16
            _assert_bf16_ulps(got["cross"][name], want[f"cross_{name}"],
                              what=f"cross {name}")
        (self_kv,) = got["layers"]
        assert got["remainder"] == []
        assert self_kv["k"].dtype == torch.bfloat16
        for name, leaf in self_kv.items():
            np.testing.assert_array_equal(_np(leaf), _np(want["self"][name]))
        assert got["pos"].tolist() == [0] * B
    carried = cache_from_numpy(jax.tree.map(np.asarray, want), "cpu")
    assert tree.leaves_with_path(carried)[0][0] == \
        tree.leaves_with_path(got)[0][0]
    with pytest.raises(ValueError, match="needs frames"):
        registry.make_cache(tp, pcfg, B, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        registry.make_cache(tp, pcfg, B, MAX_LEN, tf, kv_layout="paged",
                            block_size=8, device="cpu")


def _prefilled(cfg, pcfg, params, tp, jf, tf):
    """Both packages' scanned prefill of right-padded prompts (row 1
    shorter, row 2 inactive) over the frames' cross-KV."""
    toks = _tokens(cfg, (B, 9), seed=3)
    lens = np.array([9, 4, 0], np.int32)
    jl, jc = REF_PREFILL(params, cfg, jnp.asarray(toks), jnp.asarray(lens),
                         MAX_LEN, frames=jf)
    tl, tc = registry.apply_prefill(tp, pcfg, torch.from_numpy(toks).long(),
                                    torch.from_numpy(lens), MAX_LEN,
                                    frames=tf)
    return (jl, jc), (tl, tc), lens


def test_decode_steps_match_reference():
    """The scanned prefill and then six ``decode_step_encdec`` steps
    (ring self-attention, cross-attention over the static cross-KV):
    logits within ``LOGIT_TOL`` each step, positions exact, the self-KV
    within a bf16 ulp; the cross-KV unchanged by the steps; the port
    also decodes from the reference's cache carried over."""
    cfg, pcfg, params, tp = model(ARCH)
    jf, tf = _frames(cfg)
    (jl, jc), (tl, tc), lens = _prefilled(cfg, pcfg, params, tp, jf, tf)
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= LOGIT_TOL
    assert tc["pos"].tolist() == lens.tolist()
    cross = {k: v.clone() for k, v in tc["cross"].items()}
    carried = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    rng = np.random.default_rng(5)
    for step in range(6):
        cur = rng.integers(1, cfg.vocab_size, size=B).astype(np.int32)
        jl, jc = REF_DECODE(params, cfg, jnp.asarray(cur), jc)
        tl, tc = registry.apply_decode(tp, pcfg, torch.from_numpy(cur), tc)
        cl, carried = registry.apply_decode(tp, pcfg, torch.from_numpy(cur),
                                            carried)
        assert tl.shape == (B, cfg.vocab_size)
        assert np.abs(tl.numpy() - np.asarray(jl)).max() <= LOGIT_TOL, step
        assert np.abs(cl.numpy() - np.asarray(jl)).max() <= LOGIT_TOL, step
    assert tc["pos"].tolist() == (lens + 6).tolist()
    for name in ("k", "v"):
        _assert_bf16_ulps(tc["layers"][0][name], jc["self"][name],
                          what=f"self {name}")
        assert torch.equal(tc["cross"][name], cross[name])
    np.testing.assert_array_equal(tc["layers"][0]["k_pos"].numpy(),
                                  np.asarray(jc["self"]["k_pos"]))


def test_merge_prefill_matches_reference():
    """``registry.merge_prefill``: the self-KV rows of the prefill cache
    where active replace the live cache's, the live cache's cross-KV is
    kept (also where the prefill's differs), bit for bit the reference's
    ``merge_cache_encdec`` on the same two caches."""
    cfg, pcfg, params, tp = model(ARCH)
    jf, tf = _frames(cfg)
    _, (_, new), lens = _prefilled(cfg, pcfg, params, tp, jf, tf)
    _, other = _frames(cfg, seed=9)
    old = registry.make_cache(tp, pcfg, B, MAX_LEN, other, device="cpu")
    old["layers"][0]["k"].normal_(generator=torch.Generator().manual_seed(4))
    old["layers"][0]["k_pos"].fill_(7)
    old["pos"].fill_(7)
    active = torch.from_numpy(lens > 0)

    def to_ref(c):
        return {"pos": to_jax(c["pos"]),
                "self": {k: to_jax(v) for k, v in c["layers"][0].items()},
                "cross_k": to_jax(c["cross"]["k"]),
                "cross_v": to_jax(c["cross"]["v"])}

    want = ref_encdec.merge_cache_encdec(to_ref(old), to_ref(new),
                                         jnp.asarray(lens > 0))
    old_cross = {k: v.clone() for k, v in old["cross"].items()}
    got = registry.merge_prefill(pcfg, old, new, active)
    assert got["cross"] is old["cross"]
    for name in ("k", "v"):
        assert torch.equal(got["cross"][name], old_cross[name])
    carried = cache_from_numpy(jax.tree.map(np.asarray, want), "cpu")
    for a, b in zip(tree.leaves(got), tree.leaves(carried)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_param_tree_crosses_bitwise():
    """The port's init has the reference's init's tree (key paths in
    JAX's flatten order, shapes and dtypes: stacked encoder and decoder
    blocks, ``{g, b}`` norms, ``enc_pos``), and the leaves cross to the
    reference and back (``interop.params_from_numpy``) bit for bit."""
    cfg, pcfg, params, tp = model(ARCH)
    ref = jax.eval_shape(lambda: ref_registry.init_model(
        jax.random.PRNGKey(0), cfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(ref)
    ours = tree.leaves_with_path(tp)
    assert ["/".join(str(k) for k in p) for p, _ in flat] == [
        tree.path_str(p) for p, _ in ours]
    for (_, want), (_, got) in zip(flat, ours):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == want.dtype.name
    back = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    for got, want in zip(tree.leaves(back), tree.leaves(tp)):
        assert got.dtype == want.dtype
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert tuple(tp["enc_pos"].shape) == (cfg.n_enc_tokens, cfg.d_model)
    assert tuple(tp["dec_blocks"]["xattn"]["wq"].shape) == (
        cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.hd())


class _Spy:
    """Records every quantised product (``policy.qmatmul``) as (rows,
    d_in, d_out, seed, counter)."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = port_policy.qmatmul

        def spy(x, w, policy, seed, counter):
            self.calls.append((x.shape[0], w.shape[0], w.shape[1], seed,
                               float(counter)))
            return orig(x, w, policy, seed, counter)

        monkeypatch.setattr(port_policy, "qmatmul", spy)

    def take(self):
        out, self.calls = self.calls, []
        return out


def test_plain_and_quantised_products(monkeypatch):
    """Under the dither policy, as the reference computes it: the encoder
    is quantised at counter 0 when the cache is built, the cache's
    cross-K/V projections are plain (the cross-KV equals the plain
    products of the policy encoder's output); in a decode step every
    product of the self-attention (seeds 1-4), the cross-attention's q
    and o (seeds 1 and 4) and the MLP (5, 7) is quantised at the step's
    counter, the tied head plain (no seed 9); in the forward the
    cross-attention's k and v project the encoder output through
    ``dense`` (quantised) and the head is plain again."""
    cfg, pcfg, params, tp = model(ARCH)
    _, tf = _frames(cfg)
    pol = QuantPolicy(scheme="dither", backend="torch-ref")
    d, f, t, nl = cfg.d_model, cfg.d_ff, cfg.n_enc_tokens, cfg.n_layers
    layer = [(d, d, 1), (d, d, 2), (d, d, 3), (d, d, 4), (d, f, 5),
             (f, d, 7)]
    spy = _Spy(monkeypatch)

    cache = registry.make_cache(tp, pcfg, B, MAX_LEN, tf, policy=pol,
                                device="cpu")
    got = spy.take()
    assert got == [(B * t, i, o, s, 0.0) for i, o, s in layer] \
        * cfg.n_enc_layers
    enc = encdec.encode(tp, pcfg, tf, policy=pol)
    spy.take()
    for i in range(nl):
        xk = port_policy.matmul(enc, tp["dec_blocks"]["xattn"]["wk"][i])
        assert torch.equal(cache["cross"]["k"][i],
                           xk.reshape(cache["cross"]["k"][i].shape))

    registry.apply_decode(tp, pcfg, torch.tensor([1, 2, 3]), cache,
                          policy=pol, counter=11)
    step = [(B, i, o, s, 11.0) for i, o, s in layer[:4]] \
        + [(B, d, d, 1, 11.0), (B, d, d, 4, 11.0)] \
        + [(B, i, o, s, 11.0) for i, o, s in layer[4:]]
    assert spy.take() == step * nl

    toks = torch.from_numpy(_tokens(cfg, (B, 5)))
    registry.apply_model(tp, pcfg, {"tokens": toks, "frames": tf},
                         policy=pol, counter=2, remat=False)
    got = spy.take()
    enc_calls = [(B * t, i, o, s, 2.0) for i, o, s in layer]
    dec = [(B * 5, i, o, s, 2.0) for i, o, s in layer[:4]] \
        + [(B * 5, d, d, 1, 2.0), (B * t, d, d, 2, 2.0),
           (B * t, d, d, 3, 2.0), (B * 5, d, d, 4, 2.0)] \
        + [(B * 5, i, o, s, 2.0) for i, o, s in layer[4:]]
    assert got == enc_calls * cfg.n_enc_layers + dec * nl
    assert all(c[3] != 9 for c in got)
