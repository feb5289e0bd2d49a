"""The port's Mamba-2 SSD layer (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm`` at ``mamba2_370m.reduced()`` (2 layers,
d 128, 8 heads of 32, state 32, chunk 32), on the same weights (the
port's init carried over, ``tests/_torch_zoo.py``) and inputs drawn with
numpy.

Tolerances, each for its reason:

* ``ssm_block``'s bf16 output within ``BLOCK_ATOL`` = 2⁻⁶ absolute (one
  bf16 ulp at |y| in [2, 4); outputs reach |y| ≈ 4.5): both sides
  compute the recurrence in f32 but sum the chunk einsums in other
  orders and take ``exp``/``log1p`` from other libraries, which moves a
  few values across a bf16 rounding boundary before the gated norm; the
  output projection spreads such an ulp over the row, so a small output
  moves by many of its own ulps and the bound is absolute (measured: at
  most 0.0078 at the lengths below, 0.0156 at L = 130).
* ``ssm_decode_step``: the bf16 output and the conv state within one ulp
  (measured equal), the f32 state ``h`` allclose rtol 1e-4 (measured
  1.2e-7 absolute at |h| ≈ 14).
* Token by token against the full sequence, in the port alone: within
  2⁻⁶ (the chunked quadratic form and the step-by-step recurrence sum in
  other orders; measured 6.1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_zoo import model, ref_jit, to_jax
from repro.models import ssm as ref_ssm
from repro_torch.models import ssm

REF_CFG, CFG, REF_PARAMS, PARAMS = model("mamba2_370m")
REF_BLOCK = jax.tree.map(lambda x: x[0], REF_PARAMS["blocks"][0]["ssm"])
BLOCK = {k: v[0] for k, v in PARAMS["blocks"][0]["ssm"].items()}
REF_SSM_BLOCK = ref_jit(ref_ssm.ssm_block)
REF_SSM_STEP = ref_jit(ref_ssm.ssm_decode_step)
STATE_RTOL = 1e-4
BLOCK_ATOL = 2.0 ** -6


def _bf16(shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).bfloat16()


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32)).astype(np.float64)


def assert_bf16_ulps(got, want, n=1):
    """|got − want| ≤ n bf16 ulps of the larger magnitude."""
    got, want = _f32(got), _f32(want)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= n * ulp), np.abs(got - want).max()


def test_config_is_the_reference_config():
    import dataclasses

    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config

    for arch in ("mamba2_370m", "mamba2-370m"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            ref_get_config("mamba2_370m"))
    assert dataclasses.asdict(CFG) == dataclasses.asdict(REF_CFG)


def test_init_has_the_reference_tree():
    """The port's SSD parameters and state have the reference's keys,
    shapes and dtypes."""
    want = ref_ssm.init_ssm(jax.random.PRNGKey(0), REF_CFG)
    got = ssm.init_ssm(torch.Generator().manual_seed(0), CFG, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name, k
    np.testing.assert_allclose(got["a_log"].numpy(), np.asarray(want["a_log"]),
                               rtol=1e-6)
    ws = ref_ssm.init_ssm_state(REF_CFG, 3)
    gs = ssm.init_ssm_state(CFG, 3, device="cpu")
    for k in ws:
        assert tuple(gs[k].shape) == ws[k].shape
        assert not gs[k].any()


def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` is logaddexp(x, 0), not torch's ``softplus``,
    which returns x itself above 20."""
    x = np.array([-30.0, -1.0, 0.0, 0.5, 19.0, 20.5, 40.0], np.float32)
    np.testing.assert_allclose(ssm.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6)


@pytest.mark.parametrize("length", [1, 31, 32, 70])
def test_ssm_block_matches_reference(length):
    """The chunked SSD at lengths below, at, and across chunk boundaries
    (31 and 70 pad their last chunk)."""
    u = _bf16((2, length, CFG.d_model), length)
    got = ssm.ssm_block(BLOCK, CFG, u)
    want = REF_SSM_BLOCK(REF_BLOCK, REF_CFG, to_jax(u))
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == want.shape
    assert np.abs(_f32(got) - _f32(want)).max() <= BLOCK_ATOL


def test_ssm_decode_step_matches_reference():
    """One decode step from a random nonzero state: output, conv state and
    the f32 state h."""
    rng = np.random.default_rng(5)
    state = ssm.init_ssm_state(CFG, 2, device="cpu")
    state["h"] = torch.from_numpy(
        rng.normal(size=state["h"].shape).astype(np.float32))
    state["conv"] = _bf16(state["conv"].shape, 6)
    u = _bf16((2, 1, CFG.d_model), 7)
    out, new = ssm.ssm_decode_step(BLOCK, CFG, u, state)
    want, wnew = REF_SSM_STEP(REF_BLOCK, REF_CFG, to_jax(u),
                              {k: to_jax(v) for k, v in state.items()})
    assert_bf16_ulps(out, want)
    assert_bf16_ulps(new["conv"], wnew["conv"])
    np.testing.assert_allclose(new["h"].numpy(), np.asarray(wnew["h"]),
                               rtol=STATE_RTOL, atol=1e-6)
    # the step leaves its input state as it was
    assert torch.equal(state["conv"], _bf16(state["conv"].shape, 6))


@pytest.mark.parametrize("length", [5, 40])
def test_token_by_token_equals_full_sequence(length):
    """Decode steps from the zero state over a sequence give the
    full-sequence block's outputs (the reference's SSD duality)."""
    u = _bf16((2, length, CFG.d_model), 9 + length)
    full = ssm.ssm_block(BLOCK, CFG, u).float()
    state = ssm.init_ssm_state(CFG, 2, device="cpu")
    outs = []
    for t in range(length):
        out, state = ssm.ssm_decode_step(BLOCK, CFG, u[:, t:t + 1], state)
        outs.append(out)
    assert (torch.cat(outs, dim=1).float() - full).abs().max() <= 2.0 ** -6
