"""The port's RG-LRU block (``repro_torch.models.hybrid``) and GELU MLP
against the reference's ``repro.models.hybrid`` and ``layers.mlp`` at
``recurrentgemma_9b.reduced()`` (3 layers: rglru, rglru, attn; d 128, 4
heads, window 64), on the same weights (the port's init carried over,
``tests/_torch_zoo.py``) and inputs drawn with numpy.

Tolerances, each for its reason:

* The log-depth (Hillis–Steele) scan against ``jax.lax.associative_scan``
  allclose rtol 1e-5, atol 1e-5: both combine the same operator in other
  trees, so the f32 products and sums round differently (measured at
  most 9.5e-7 at |h| ≈ 7, L up to 200).
* ``rglru_block``'s bf16 output within 2⁻⁶ absolute, for the reason
  ``tests/test_torch_ssm.py`` gives (measured 0.00195 at |y| ≈ 2.75, L =
  70); ``rglru_decode_step``'s output and the GELU MLP's within one bf16
  ulp of the larger magnitude (the tanh of the GELU differs between the
  libraries); the f32 state h allclose rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_zoo import model, ref_jit, to_jax
from repro.models import hybrid as ref_hybrid
from repro.models import layers as ref_layers
from repro_torch.models import hybrid, layers
from test_torch_ssm import BLOCK_ATOL, _bf16, _f32, assert_bf16_ulps

REF_CFG, CFG, REF_PARAMS, PARAMS = model("recurrentgemma_9b")
REF_REC = jax.tree.map(lambda x: x[0], REF_PARAMS["blocks"][0]["rec"])
REC = {k: v[0] for k, v in PARAMS["blocks"][0]["rec"].items()}
REF_RGLRU_BLOCK = ref_jit(ref_hybrid.rglru_block)
REF_RGLRU_STEP = ref_jit(ref_hybrid.rglru_decode_step)


def test_config_and_block_pattern_are_the_reference():
    import dataclasses

    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config

    full = get_config("recurrentgemma-9b")
    assert dataclasses.asdict(full) == dataclasses.asdict(
        ref_get_config("recurrentgemma_9b"))
    assert dataclasses.asdict(CFG) == dataclasses.asdict(REF_CFG)
    # 38 layers: 12 × (rglru, rglru, attn) stacked, then 2 rglru
    kinds = [full.layer_kind(i) for i in range(full.n_layers)]
    assert kinds[-2:] == ["rglru", "rglru"] and kinds.count("attn") == 12
    assert sorted(PARAMS["blocks"][0]) == sorted(REF_PARAMS["blocks"][0])
    assert sorted(PARAMS["blocks"][2]) == sorted(REF_PARAMS["blocks"][2])
    want = ref_hybrid.init_rglru(jax.random.PRNGKey(0), REF_CFG)
    got = hybrid.init_rglru(torch.Generator().manual_seed(0), CFG,
                            device="cpu")
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k


@pytest.mark.parametrize("length", [1, 5, 64, 70, 200])
def test_log_depth_scan_matches_associative_scan(length):
    rng = np.random.default_rng(length)
    a = rng.uniform(0.5, 1.0, size=(2, length, 16)).astype(np.float32)
    b = rng.normal(size=(2, length, 16)).astype(np.float32)

    def combine(lhs, rhs):
        return lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    got = hybrid.linear_scan(torch.from_numpy(a), torch.from_numpy(b), dim=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("length", [1, 5, 64, 70])
def test_rglru_block_matches_reference(length):
    u = _bf16((2, length, CFG.d_model), length)
    got = hybrid.rglru_block(REC, CFG, u)
    want = REF_RGLRU_BLOCK(REF_REC, REF_CFG, to_jax(u))
    assert tuple(got.shape) == want.shape
    assert np.abs(_f32(got) - _f32(want)).max() <= BLOCK_ATOL


def test_rglru_decode_step_matches_reference():
    rng = np.random.default_rng(3)
    state = hybrid.init_rglru_state(CFG, 2, device="cpu")
    state["h"] = torch.from_numpy(
        rng.normal(size=state["h"].shape).astype(np.float32))
    state["conv"] = _bf16(state["conv"].shape, 4)
    u = _bf16((2, 1, CFG.d_model), 5)
    out, new = hybrid.rglru_decode_step(REC, CFG, u, state)
    want, wnew = REF_RGLRU_STEP(REF_REC, REF_CFG, to_jax(u),
                                {k: to_jax(v) for k, v in state.items()})
    assert_bf16_ulps(out, want)
    assert_bf16_ulps(new["conv"], wnew["conv"])
    np.testing.assert_allclose(new["h"].numpy(), np.asarray(wnew["h"]),
                               rtol=1e-4, atol=1e-6)
    # token by token from the zero state ≡ the scanned block
    u = _bf16((2, 12, CFG.d_model), 6)
    state = hybrid.init_rglru_state(CFG, 2, device="cpu")
    outs = []
    for t in range(12):
        out, state = hybrid.rglru_decode_step(REC, CFG, u[:, t:t + 1], state)
        outs.append(out)
    step_out = _f32(torch.cat(outs, dim=1))
    assert np.abs(step_out - _f32(hybrid.rglru_block(REC, CFG, u))).max() \
        <= BLOCK_ATOL


def test_gelu_mlp_with_biases_matches_reference():
    """The GELU MLP ``{wu, wd, bu, bd}`` with random biases (zeros at
    init): the tanh-approximated GELU of ``jax.nn.gelu``, in f32."""
    mp = {k: v[0].clone() for k, v in PARAMS["blocks"][0]["mlp"].items()}
    assert sorted(mp) == ["bd", "bu", "wd", "wu"]
    mp["bu"] = _bf16(mp["bu"].shape, 11) * 0.5
    mp["bd"] = _bf16(mp["bd"].shape, 12) * 0.5
    x = _bf16((2, 9, CFG.d_model), 13)
    got = layers.mlp(mp, x, "gelu")
    want = ref_layers.mlp({k: to_jax(v) for k, v in mp.items()}, to_jax(x),
                          "gelu")
    assert_bf16_ulps(got, want)
    xs = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(
        layers.gelu(torch.from_numpy(xs)).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(xs))), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="mlp_act"):
        layers.mlp(mp, x, "relu")
