"""The port's decode-attention plain version (``repro_torch.kernels.ref``,
reached through ``dispatch.decode_attention`` on CPU tensors) against the
reference's oracle ``repro.kernels.ref.decode_attention_ref`` and its Pallas
kernel in interpret mode.  The CUDA kernel is held against the plain
version on a card by ``tests/test_torch_cuda.py``.

Tolerances are f32 allclose (atol = rtol = 1e-5): both sides run the same
recurrence in f32 and differ only in summation order (about 1e-7 here).
They are not bitwise: ``pallas-interpret`` itself differs from ``xla-ref``
by one ulp in some cases on jax 0.9.0 (ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import dispatch as ref_dispatch
from repro.kernels import ref as ref_oracle
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import decode_attention as da

ATOL = RTOL = 1e-5


def _ring_inputs(seed, *, b=4, cap=64, nkv=2, group=2, hd=32,
                 quantized=False, pos_vals=(5, 40, 63, 150)):
    """A ring-cache snapshot as numpy arrays: slot s of row i holds the
    latest position p ≡ s (mod cap) with p ≤ pos_i (so pos ≥ cap wraps);
    unwritten slots carry k_pos = -1 and arbitrary data."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, nkv, group, hd)).astype(np.float32)
    pos = np.asarray(pos_vals[:b], np.int32)
    kpos = np.full((b, cap), -1, np.int32)
    for i in range(b):
        for p in range(int(pos[i]) + 1):
            kpos[i, p % cap] = p
    if quantized:
        k = rng.integers(-127, 128, size=(b, cap, nkv, hd)).astype(np.int8)
        v = rng.integers(-127, 128, size=(b, cap, nkv, hd)).astype(np.int8)
        ks = rng.uniform(0.1, 2.0, size=(b, cap, nkv)).astype(np.float32)
        vs = rng.uniform(0.1, 2.0, size=(b, cap, nkv)).astype(np.float32)
    else:
        k = rng.normal(size=(b, cap, nkv, hd)).astype(np.float32)
        v = rng.normal(size=(b, cap, nkv, hd)).astype(np.float32)
        ks = vs = None
    return q, k, v, kpos, pos, ks, vs


def _jax(arrs, quantized):
    q, k, v, kpos, pos, ks, vs = arrs
    cache = jnp.int8 if quantized else jnp.bfloat16
    return (jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, cache),
            jnp.asarray(v, cache), jnp.asarray(kpos), jnp.asarray(pos),
            None if ks is None else jnp.asarray(ks),
            None if vs is None else jnp.asarray(vs))


def _torch(arrs, quantized, device="cpu"):
    q, k, v, kpos, pos, ks, vs = arrs
    conv = (lambda a: torch.from_numpy(a)) if quantized else (
        lambda a: torch.from_numpy(a).to(torch.bfloat16))
    out = (torch.from_numpy(q).to(torch.bfloat16), conv(k), conv(v),
           torch.from_numpy(kpos), torch.from_numpy(pos),
           None if ks is None else torch.from_numpy(ks),
           None if vs is None else torch.from_numpy(vs))
    return [None if t is None else t.to(device) for t in out]


CASES = [(quant, window, group)
         for quant in (False, True) for window in (0, 16)
         for group in (1, 2, 3)]


@pytest.mark.parametrize("quant,window,group", CASES)
def test_plain_matches_reference_oracle(quant, window, group):
    """Dispatch on CPU tensors (the plain version, one whole-cap block)
    against the reference's oracle at its default whole-cap block."""
    arrs = _ring_inputs(group + 10 * window, group=group, quantized=quant)
    jq, jk, jv, jkp, jpos, jks, jvs = _jax(arrs, quant)
    want = np.asarray(ref_oracle.decode_attention_ref(
        jq, jk, jv, jkp, jpos, jks, jvs, window=window))
    q, k, v, kp, pos, ks, vs = _torch(arrs, quant)
    got = dispatch.decode_attention(q, k, v, kp, pos, k_scale=ks,
                                    v_scale=vs, window=window).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("quant,window,group", [
    (False, 0, 3), (True, 16, 3), (True, 0, 1), (False, 16, 2)])
def test_plain_blocked_matches_pallas_interpret(quant, window, group):
    """The per-block recurrence with the same block (16 slots, so rows of
    several blocks, skipped blocks and a wrapped ring) against the Pallas
    kernel body run in interpret mode."""
    arrs = _ring_inputs(7 + group, group=group, quantized=quant)
    jq, jk, jv, jkp, jpos, jks, jvs = _jax(arrs, quant)
    want = np.asarray(ref_dispatch.decode_attention(
        jq, jk, jv, jkp, jpos, k_scale=jks, v_scale=jvs, window=window,
        block=(16,), backend="pallas-interpret"))
    q, k, v, kp, pos, ks, vs = _torch(arrs, quant)
    got = ref.decode_attention_ref(q, k, v, kp, pos, ks, vs, window=window,
                                   block=(16,)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_fully_masked_row_is_uniform_not_nan():
    """A row whose every slot is masked weighs the -1e30 logits of the
    blocks it processed uniformly, as the reference does — never NaN."""
    arrs = list(_ring_inputs(3, group=2))
    arrs[3] = np.full_like(arrs[3], -1)              # no slot written
    jq, jk, jv, jkp, jpos, _, _ = _jax(arrs, False)
    q, k, v, kp, pos, _, _ = _torch(arrs, False)
    for block in (None, (16,)):
        want = np.asarray(ref_oracle.decode_attention_ref(
            jq, jk, jv, jkp, jpos, window=0, block=block))
        got = ref.decode_attention_ref(q, k, v, kp, pos, window=0,
                                       block=block).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_dispatch_backend_selection():
    """``backend=None`` takes CPU tensors to the plain version; ``cuda``
    on a CPU tensor and unknown names raise; nothing reads the
    environment."""
    q, k, v, kp, pos, _, _ = _torch(_ring_inputs(1), False)
    assert dispatch.resolve_backend(None, q) == "torch-ref"
    launches = da.decode_attention.launches
    a = dispatch.decode_attention(q, k, v, kp, pos)
    b = dispatch.decode_attention(q, k, v, kp, pos, backend="torch-ref")
    assert torch.equal(a, b)
    assert da.decode_attention.launches == launches   # the plain version
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dispatch.decode_attention(q, k, v, kp, pos, backend="cuda")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        dispatch.decode_attention(q, k, v, kp, pos, backend="pallas")
