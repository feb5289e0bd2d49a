"""The port's paged flash-decode plain version
(``repro_torch.kernels.ref.paged_decode_attention_ref``, reached through
``dispatch.paged_decode_attention`` on CPU tensors) against the reference's
oracle (``xla-ref``) and its Pallas kernel in interpret mode, and — inside
the port — against the ring recurrence on the same token stream.  The CUDA
kernel is held against the plain version on a card by
``tests/test_torch_cuda.py``.

Tolerances: against the reference, f32 allclose (atol = rtol = 1e-5), the
same recurrence in another summation order (as in
``tests/test_torch_decode_attention.py``).  Paged against ring inside the
port: **bitwise**, since both run one recurrence body on the same tiles
when the ring's block equals the pool block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as ref_dispatch
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import paged_decode_attention as pda
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = RTOL = 1e-5


def _stream(seed, *, b=4, bs=16, max_len=64, nkv=2, group=2, hd=32,
            quantized=True, pos_vals=(5, 40, 63, 0), share=(), idle=()):
    """One token stream in both layouts, as numpy arrays: a ring per slot
    (k_pos-tracked, no wrap) and a pool whose blocks are handed out in a
    shuffled order through a block table, with a poisoned trash block.
    Rows in ``share`` reuse row 0's first two blocks (a prefix hit: their
    first 2·bs positions hold row 0's K/V); rows in ``idle`` point every
    table entry at the trash block."""
    rng = np.random.default_rng(seed)
    nbmax = max_len // bs
    nblk = b * nbmax
    q = rng.normal(size=(b, nkv, group, hd)).astype(np.float32)
    pos = np.asarray(pos_vals[:b], np.int32)
    kdt = np.int8 if quantized else np.float32
    ring = {n: np.zeros((b, max_len, nkv, hd), kdt) for n in "kv"}
    ring_s = {n: np.zeros((b, max_len, nkv), np.float32) for n in "kv"}
    kpos = np.full((b, max_len), -1, np.int32)
    pool = {n: np.zeros((nblk + 1, bs, nkv, hd), kdt) for n in "kv"}
    pool_s = {n: np.zeros((nblk + 1, bs, nkv), np.float32) for n in "kv"}
    for n in "kv":
        pool[n][nblk] = 111 if quantized else 1e4         # poison
        pool_s[n][nblk] = 3.0
    bt = np.full((b, nbmax), nblk, np.int32)
    perm = list(rng.permutation(nblk))
    for i in range(b):
        if i in idle:
            continue
        for p in range(int(pos[i]) + 1):
            j, t = p // bs, p % bs
            shared = i in share and j < 2
            if t == 0:
                bt[i, j] = bt[0, j] if shared else perm.pop()
            if shared:
                kv = [ring[n][0, p] for n in "kv"]
                sc = [ring_s[n][0, p] for n in "kv"]
            else:
                if quantized:
                    kv = rng.integers(-127, 128, size=(2, nkv, hd))
                else:
                    kv = rng.normal(size=(2, nkv, hd))
                sc = rng.uniform(0.1, 2.0, size=(2, nkv))
            for x, n in enumerate("kv"):
                ring[n][i, p] = kv[x]
                ring_s[n][i, p] = sc[x]
                pool[n][bt[i, j], t] = kv[x]
                pool_s[n][bt[i, j], t] = sc[x]
            kpos[i, p] = p
    return dict(q=q, pos=pos, bt=bt, k_pos=kpos, ring=ring, ring_s=ring_s,
                pool=pool, pool_s=pool_s, quantized=quantized)


def _jax_pool(d):
    cast = jnp.int8 if d["quantized"] else jnp.bfloat16
    sc = ((jnp.asarray(d["pool_s"]["k"]), jnp.asarray(d["pool_s"]["v"]))
          if d["quantized"] else (None, None))
    return (jnp.asarray(d["q"], jnp.bfloat16),
            jnp.asarray(d["pool"]["k"], cast), jnp.asarray(d["pool"]["v"], cast),
            jnp.asarray(d["bt"]), jnp.asarray(d["pos"])) + sc


def _torch(d, layout):
    conv = (torch.from_numpy if d["quantized"]
            else (lambda a: torch.from_numpy(a).to(torch.bfloat16)))
    src, scales = (d["pool"], d["pool_s"]) if layout == "pool" else (
        d["ring"], d["ring_s"])
    index = d["bt"] if layout == "pool" else d["k_pos"]
    sc = ((torch.from_numpy(scales["k"]), torch.from_numpy(scales["v"]))
          if d["quantized"] else (None, None))
    return (torch.from_numpy(d["q"]).to(torch.bfloat16), conv(src["k"]),
            conv(src["v"]), torch.from_numpy(index),
            torch.from_numpy(d["pos"])) + sc


CASES = [(quant, window, group) for quant in (False, True)
         for window in (0, 16) for group in (1, 2, 4)]


@pytest.mark.parametrize("quant,window,group", CASES)
def test_plain_matches_reference_oracle_and_interpret(quant, window, group):
    """Shuffled physical ids, rows 1 and 2 sharing row 0's first two
    blocks, row 3 idle on the trash block: the plain version against the
    reference's ``xla-ref`` oracle and its Pallas kernel in interpret
    mode, every row."""
    d = _stream(group + 10 * window, group=group, quantized=quant,
                pos_vals=(47, 40, 63, 0), share=(1, 2), idle=(3,))
    jq, jk, jv, jbt, jpos, jks, jvs = _jax_pool(d)
    q, k, v, bt, pos, ks, vs = _torch(d, "pool")
    launches = pda.paged_decode_attention.launches
    got = dispatch.paged_decode_attention(q, k, v, bt, pos, k_scale=ks,
                                          v_scale=vs, window=window).numpy()
    assert pda.paged_decode_attention.launches == launches  # plain version
    assert got.dtype == np.float32 and np.isfinite(got).all()
    for backend in ("xla-ref", "pallas-interpret"):
        want = np.asarray(ref_dispatch.paged_decode_attention(
            jq, jk, jv, jbt, jpos, k_scale=jks, v_scale=jvs, window=window,
            backend=backend))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=backend)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [0, 16], ids=["full", "window16"])
def test_plain_paged_bitwise_equals_plain_ring(quant, window):
    """Inside the port, paged ≡ ring bit for bit on the same token stream:
    with ``cap == bs`` (one block each) and with the ring run in blocks of
    the pool's size.  The trash block is poisoned, so no unallocated entry
    leaks in."""
    for bs, max_len, block in ((64, 64, None), (16, 64, (16,))):
        d = _stream(7 + bs, bs=bs, max_len=max_len, quantized=quant,
                    pos_vals=(5, 40, 63, 17), share=(2,))
        q, rk, rv, kp, pos, rks, rvs = _torch(d, "ring")
        ring = ref.decode_attention_ref(q, rk, rv, kp, pos, rks, rvs,
                                        window=window, block=block)
        q, pk, pv, bt, pos, pks, pvs = _torch(d, "pool")
        paged = ref.paged_decode_attention_ref(q, pk, pv, bt, pos, pks, pvs,
                                               window=window)
        assert torch.equal(ring, paged), (bs, quant, window)


def test_dispatch_paged_backend_selection():
    """``backend=None`` takes CPU tensors to the plain version; ``cuda`` on
    a CPU tensor and unknown names raise."""
    q, k, v, bt, pos, ks, vs = _torch(_stream(1), "pool")
    assert torch.equal(
        dispatch.paged_decode_attention(q, k, v, bt, pos, k_scale=ks,
                                        v_scale=vs),
        dispatch.paged_decode_attention(q, k, v, bt, pos, k_scale=ks,
                                        v_scale=vs, backend="torch-ref"))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dispatch.paged_decode_attention(q, k, v, bt, pos, k_scale=ks,
                                        v_scale=vs, backend="cuda")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        dispatch.paged_decode_attention(q, k, v, bt, pos, backend="xla-ref")
