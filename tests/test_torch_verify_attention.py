"""The port's plain speculative-verify attention (``ref.verify_attention_ref``
and ``ref.paged_verify_attention_ref``, reached through
``dispatch.verify_attention`` / ``dispatch.paged_verify_attention`` on CPU
tensors) against the reference's oracles of the same names (``xla-ref``),
and — inside the port — each verify row against the port's decode at its
position.  The CUDA kernels are held against these plain versions on a
card by ``tests/test_torch_cuda.py``.

Tolerances: against the reference, f32 allclose at atol = rtol = 1e-6:
the same per-row recurrence, summed in another order by another library.
The reference's Pallas kernels in interpret mode are not the oracle here:
they are one ulp off their own oracle on this JAX (ROADMAP Queue 3).
Inside the port: **bitwise** — verify row t is by construction the decode
recurrence at ``pos + t``, and paged verify at bs == bk the ring verify.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as ref_dispatch
from repro_torch.kernels import dispatch, ref
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = RTOL = 1e-6


def _ring(seed, *, b=3, cap=32, nkv=2, group=2, hd=32, kq=4, quantized=True,
          pos_vals=(5, 20, 30)):
    """A ring mid-verify, as numpy arrays: each slot holds positions up to
    pos + kq - 1 (the draft rows' writes; the cap - 2 slot wraps), unwritten
    slots k_pos = -1 with codes that masking must hide."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kq, nkv, group, hd)).astype(np.float32)
    kpos = np.full((b, cap), -1, np.int32)
    for i, p in enumerate(pos_vals[:b]):
        for x in range(p + kq):
            kpos[i, x % cap] = x
    if quantized:
        k, v = (rng.integers(-127, 128, size=(b, cap, nkv, hd)).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(0.1, 2.0, size=(b, cap, nkv)).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.normal(size=(b, cap, nkv, hd)).astype(np.float32)
                for _ in range(2))
        ks = vs = None
    return q, k, v, kpos, np.asarray(pos_vals[:b], np.int32), ks, vs


def _pool(seed, *, b=3, bs=4, nbmax=8, nkv=2, group=2, hd=32, kq=4,
          quantized=True, pos_vals=(5, 13, 30)):
    """A paged pool mid-verify: shuffled block ids, row 1 sharing row 0's
    first block, a poisoned trash block; row 2 sits two short of the
    table's end, so its last rows run past it."""
    rng = np.random.default_rng(seed)
    nblk = b * nbmax
    q = rng.normal(size=(b, kq, nkv, group, hd)).astype(np.float32)
    if quantized:
        k, v = (rng.integers(-127, 128, size=(nblk + 1, bs, nkv, hd))
                .astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.1, 2.0, size=(nblk + 1, bs, nkv))
                  .astype(np.float32) for _ in range(2))
        k[nblk] = v[nblk] = 111
    else:
        k, v = (rng.normal(size=(nblk + 1, bs, nkv, hd)).astype(np.float32)
                for _ in range(2))
        k[nblk] = v[nblk] = 1e4
        ks = vs = None
    ids = list(rng.permutation(nblk))
    bt = np.full((b, nbmax), nblk, np.int32)
    for i, p in enumerate(pos_vals[:b]):
        for j in range(min((p + kq - 1) // bs, nbmax - 1) + 1):
            bt[i, j] = bt[0, j] if i == 1 and j == 0 else ids.pop()
    return q, k, v, bt, np.asarray(pos_vals[:b], np.int32), ks, vs


def _to_jax(arrs, bf16):
    out = []
    for i, a in enumerate(arrs):
        if a is None:
            out.append(None)
        elif a.dtype == np.float32 and i < 3 and bf16:
            out.append(jnp.asarray(a, jnp.bfloat16))
        else:
            out.append(jnp.asarray(a))
    return out


def _to_torch(arrs, bf16):
    out = []
    for i, a in enumerate(arrs):
        if a is None:
            out.append(None)
        elif a.dtype == np.float32 and i < 3 and bf16:
            out.append(torch.from_numpy(a).to(torch.bfloat16))
        else:
            out.append(torch.from_numpy(a))
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [0, 16], ids=["full", "window16"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_verify_matches_reference_oracle(quantized, window, group):
    """Ring verify, plain port version vs the reference's
    ``verify_attention_ref``, whole-cap blocks on both sides."""
    arrs = _ring(group, group=group, quantized=quantized)
    q, k, v, kp, pos, ks, vs = _to_jax(arrs, True)
    want = ref_dispatch.verify_attention(q, k, v, kp, pos, k_scale=ks,
                                         v_scale=vs, window=window,
                                         backend="xla-ref")
    q, k, v, kp, pos, ks, vs = _to_torch(arrs, True)
    got = dispatch.verify_attention(q, k, v, kp, pos, k_scale=ks, v_scale=vs,
                                    window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [0, 8], ids=["full", "window8"])
@pytest.mark.parametrize("group", [1, 2])
def test_paged_verify_matches_reference_oracle(quantized, window, group):
    """Paged verify, plain port version vs the reference's
    ``paged_verify_attention_ref``: shuffled blocks, a shared block, a
    poisoned trash block, rows past the table's end."""
    arrs = _pool(11 + group, group=group, quantized=quantized)
    q, k, v, bt, pos, ks, vs = _to_jax(arrs, True)
    want = ref_dispatch.paged_verify_attention(
        q, k, v, bt, pos, k_scale=ks, v_scale=vs, window=window,
        backend="xla-ref")
    q, k, v, bt, pos, ks, vs = _to_torch(arrs, True)
    got = dispatch.paged_verify_attention(q, k, v, bt, pos, k_scale=ks,
                                          v_scale=vs, window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_verify_row_equals_decode_row(quantized, layout):
    """Verify row t is bit for bit the port's decode at ``pos + t`` over the
    same cache (drafted positions beyond a row's own are masked, as empty
    slots are in decode) — also at 8-slot ring blocks and past the
    cache's end."""
    if layout == "ring":
        arrs = _to_torch(_ring(7, quantized=quantized), True)
        calls = [(dispatch.verify_attention, dispatch.decode_attention),
                 (functools.partial(ref.verify_attention_ref, block=(8,)),
                  functools.partial(ref.decode_attention_ref, block=(8,)))]
    else:
        arrs = _to_torch(_pool(8, quantized=quantized), True)
        calls = [(dispatch.paged_verify_attention,
                  dispatch.paged_decode_attention)]
    q, k, v, index, pos, ks, vs = arrs
    for verify, decode in calls:
        ver = verify(q, k, v, index, pos, k_scale=ks, v_scale=vs)
        for t in range(q.shape[1]):
            one = decode(q[:, t].contiguous(), k, v, index, pos + t,
                         k_scale=ks, v_scale=vs)
            assert torch.equal(ver[:, t], one), t


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_paged_verify_equals_ring_verify_at_the_ring_block(quantized):
    """One token stream in a ring (no wrap) and in 8-token pool blocks:
    plain paged verify equals plain ring verify at 8-slot blocks, bit for
    bit, as the decode versions do."""
    b, cap, bs, kq = 3, 64, 8, 4
    q, k, v, kp, pos, ks, vs = _to_torch(
        _ring(9, b=b, cap=cap, kq=kq, quantized=quantized,
              pos_vals=(5, 20, 59)), True)
    nbmax = cap // bs
    perm = torch.from_numpy(np.random.default_rng(0).permutation(b * nbmax))
    bt = perm.reshape(b, nbmax).to(torch.int32)

    def to_pool(x):
        if x is None:
            return None
        pool = torch.zeros((b * nbmax + 1, bs) + tuple(x.shape[2:]),
                           dtype=x.dtype)
        pool[perm] = x.reshape((b * nbmax, bs) + tuple(x.shape[2:]))
        return pool

    ring = ref.verify_attention_ref(q, k, v, kp, pos, ks, vs, block=(bs,))
    paged = ref.paged_verify_attention_ref(q, to_pool(k), to_pool(v), bt, pos,
                                           to_pool(ks), to_pool(vs))
    assert torch.equal(ring, paged)


# ---------------------------------------------------------------------------
# the CUDA kernels' split order (``split=``): reduced widths (head dim 32,
# 8-slot ring tiles or 4-token pool blocks, spans of 2 tiles), so the rows
# of a window straddle span boundaries and take up to 4 splits
# ---------------------------------------------------------------------------

SPAN = 2


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [0, 16], ids=["full", "window16"])
def test_split_verify_matches_reference_oracle(quantized, window):
    """Ring verify in the split order (8-slot tiles, spans of 2) against the
    reference's ``verify_attention_ref`` and against the same tiles
    unsplit, allclose: rows straddling span boundaries (15 → 16, 31 → 32)
    and, in the slot at cap - 2, rows past the ring's end."""
    arrs = _ring(21, b=3, quantized=quantized, pos_vals=(13, 29, 30))
    q, k, v, kp, pos, ks, vs = _to_jax(arrs, True)
    want = ref_dispatch.verify_attention(q, k, v, kp, pos, k_scale=ks,
                                         v_scale=vs, window=window,
                                         backend="xla-ref")
    q, k, v, kp, pos, ks, vs = _to_torch(arrs, True)
    got = ref.verify_attention_ref(q, k, v, kp, pos, ks, vs, window=window,
                                   block=(8,), split=SPAN)
    unsplit = ref.verify_attention_ref(q, k, v, kp, pos, ks, vs,
                                       window=window, block=(8,))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), unsplit.numpy(), atol=ATOL,
                               rtol=RTOL)
    # slot 0's rows 13, 14, 15 read two tiles (one split), bit for bit
    assert torch.equal(got[0, :3], unsplit[0, :3])


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_split_verify_row_equals_decode_row(quantized, layout):
    """Under the split order verify row t is still bit for bit the decode
    at ``pos + t`` (the partition depends only on the absolute tile index):
    ring at 8-slot tiles, paged at 4-token blocks, rows across span
    boundaries and past the cache's end."""
    if layout == "ring":
        arrs = _to_torch(_ring(27, quantized=quantized, pos_vals=(13, 29, 30)),
                         True)
        kw = dict(block=(8,), split=SPAN)
        verify, decode = ref.verify_attention_ref, ref.decode_attention_ref
    else:
        arrs = _to_torch(_pool(28, quantized=quantized, pos_vals=(5, 13, 30)),
                         True)
        kw = dict(split=SPAN)
        verify = ref.paged_verify_attention_ref
        decode = ref.paged_decode_attention_ref
    q, k, v, index, pos, ks, vs = arrs
    ver = verify(q, k, v, index, pos, ks, vs, **kw)
    assert torch.isfinite(ver).all()
    for t in range(q.shape[1]):
        one = decode(q[:, t].contiguous(), k, v, index, pos + t, ks, vs,
                     **kw)
        assert torch.equal(ver[:, t], one), t


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [0, 12])
def test_split_paged_equals_ring_at_the_ring_block(quantized, window):
    """One token stream in a ring (no wrap) and in 8-token pool blocks:
    under the split order paged verify and decode equal ring verify and
    decode at 8-slot tiles, bit for bit (windows of 12 mask whole
    splits)."""
    b, cap, bs, kq = 3, 64, 8, 4
    q, k, v, kp, pos, ks, vs = _to_torch(
        _ring(29, b=b, cap=cap, kq=kq, quantized=quantized,
              pos_vals=(14, 33, 59)), True)
    nbmax = cap // bs
    perm = torch.from_numpy(np.random.default_rng(1).permutation(b * nbmax))
    bt = perm.reshape(b, nbmax).to(torch.int32)

    def to_pool(x):
        if x is None:
            return None
        pool = torch.zeros((b * nbmax + 1, bs) + tuple(x.shape[2:]),
                           dtype=x.dtype)
        pool[perm] = x.reshape((b * nbmax, bs) + tuple(x.shape[2:]))
        return pool

    pool = (to_pool(k), to_pool(v), bt, pos, to_pool(ks), to_pool(vs))
    ring = ref.verify_attention_ref(q, k, v, kp, pos, ks, vs, window=window,
                                    block=(bs,), split=SPAN)
    paged = ref.paged_verify_attention_ref(q, *pool, window=window,
                                           split=SPAN)
    assert torch.equal(ring, paged)
    q0 = q[:, 0].contiguous()
    assert torch.equal(
        ref.decode_attention_ref(q0, k, v, kp, pos, ks, vs, window=window,
                                 block=(bs,), split=SPAN),
        ref.paged_decode_attention_ref(q0, *pool, window=window, split=SPAN))
