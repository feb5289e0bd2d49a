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
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

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


# ---------------------------------------------------------------------------
# the CUDA kernels' split order (``split=``), at reduced widths: head dim
# 32, 16-slot tiles, spans of 2 tiles, so a 128-slot ring's rows take 1-4
# splits
# ---------------------------------------------------------------------------

TILE, SPAN = 16, 2
SPLIT_POS = (5, 31, 32, 63, 100, 300)   # 1, 1, 2, 2, 4 splits; 300 wraps


def _one_split_rows(pos, cap):
    return [i for i, p in enumerate(pos)
            if min(int(p) // TILE, cap // TILE - 1) < SPAN]


@pytest.mark.parametrize("quant,window,group", [
    (quant, window, group) for quant in (False, True)
    for window in (0, 16) for group in (1, 3)])
def test_split_plain_matches_reference_oracle(quant, window, group):
    """The plain version in the split order (16-slot tiles, spans of 2)
    against the reference's oracle and against the same tiles unsplit,
    allclose; every row with at most one span (at most two tiles to read)
    is bit for bit the unsplit version."""
    arrs = _ring_inputs(30 + group + window, b=6, cap=128, group=group,
                        quantized=quant, pos_vals=SPLIT_POS)
    jq, jk, jv, jkp, jpos, jks, jvs = _jax(arrs, quant)
    want = np.asarray(ref_oracle.decode_attention_ref(
        jq, jk, jv, jkp, jpos, jks, jvs, window=window))
    q, k, v, kp, pos, ks, vs = _torch(arrs, quant)
    got = ref.decode_attention_ref(q, k, v, kp, pos, ks, vs, window=window,
                                   block=(TILE,), split=SPAN)
    unsplit = ref.decode_attention_ref(q, k, v, kp, pos, ks, vs,
                                       window=window, block=(TILE,))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), unsplit.numpy(), atol=ATOL,
                               rtol=RTOL)
    one = _one_split_rows(SPLIT_POS, 128)
    assert one == [0, 1]
    assert torch.equal(got[one], unsplit[one])
    assert not torch.equal(got, unsplit)     # the other rows merge splits


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_split_masked_splits_drop_out_and_masked_rows_stay_uniform(quant):
    """A window of 8 keys masks every split of a long row but its last:
    those carry m = -1e30 and drop out of the merge (the result is the
    oracle's).  A row with no key written masks every split: it stays
    uniform over the keys of the tiles it processed, as the unsplit
    version with the same tiles does, never NaN."""
    arrs = list(_ring_inputs(41, b=6, cap=128, group=2, quantized=quant,
                             pos_vals=SPLIT_POS))
    arrs[3][2] = -1                                  # row 2: nothing written
    jq, jk, jv, jkp, jpos, jks, jvs = _jax(arrs, quant)
    want = np.asarray(ref_oracle.decode_attention_ref(
        jq, jk, jv, jkp, jpos, jks, jvs, window=8))
    q, k, v, kp, pos, ks, vs = _torch(arrs, quant)
    got = ref.decode_attention_ref(q, k, v, kp, pos, ks, vs, window=8,
                                   block=(TILE,), split=SPAN).numpy()
    unsplit = ref.decode_attention_ref(q, k, v, kp, pos, ks, vs, window=8,
                                       block=(TILE,)).numpy()
    assert np.isfinite(got).all()
    live = [0, 1, 3, 4, 5]
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[2], unsplit[2], atol=ATOL, rtol=RTOL)
    # row 2 (pos 32: tiles 0-2 processed, two splits) is the mean of the
    # values it processed
    vals = v[2, : 3 * TILE].float()
    if quant:
        vals = vals * (vs[2, : 3 * TILE, :, None] * (1.0 / 127.0))
    mean = vals.mean(dim=0).numpy()                  # (n_kv, hd)
    for g in range(got.shape[2]):
        np.testing.assert_allclose(got[2, :, g], mean, atol=ATOL, rtol=RTOL)


def _check_args(quant=True, kq=None):
    """Inputs the ring kernels take, as CPU tensors (head dim 64)."""
    b, cap, nkv, group, hd = 2, 128, 2, 2, 64
    q = torch.zeros((b,) + ((kq,) if kq else ()) + (nkv, group, hd),
                    dtype=torch.bfloat16)
    dt = torch.int8 if quant else torch.bfloat16
    k = torch.zeros((b, cap, nkv, hd), dtype=dt)
    scales = ((torch.ones((b, cap, nkv)), torch.ones((b, cap, nkv)))
              if quant else (None, None))
    return dict(q=q, k=k, v=k.clone(), k_pos=torch.zeros((b, cap),
                                                         dtype=torch.int32),
                pos=torch.zeros((b,), dtype=torch.int32), k_scale=scales[0],
                v_scale=scales[1], window=0)


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts one byte past 16."""
    raw = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.uint8)
    off = (-raw.data_ptr()) % 16 + 1
    out = raw[off:off + t.numel() * t.element_size()].view(t.dtype)
    return out.view(t.shape)


REFUSED = {
    "q rank": lambda a: dict(q=a["q"][0]),
    "k rank": lambda a: dict(k=a["k"][0]),
    "q dtype": lambda a: dict(q=a["q"].float()),
    "cache dtype": lambda a: dict(k=a["k"].float(), v=a["v"].float(),
                                  k_scale=None, v_scale=None),
    "v dtype": lambda a: dict(v=a["v"].bfloat16()),
    "k_pos dtype": lambda a: dict(k_pos=a["k_pos"].long()),
    "pos dtype": lambda a: dict(pos=a["pos"].long()),
    "scale dtype": lambda a: dict(k_scale=a["k_scale"].double()),
    "q shape": lambda a: dict(q=torch.zeros((2, 3, 2, 64),
                                            dtype=torch.bfloat16)),
    "v shape": lambda a: dict(v=a["v"][:, :64].contiguous()),
    "k_pos shape": lambda a: dict(k_pos=a["k_pos"][:, :64].contiguous()),
    "pos shape": lambda a: dict(pos=a["pos"][:1].contiguous()),
    "scale shape": lambda a: dict(v_scale=a["v_scale"][:, :64].contiguous()),
    "missing scales": lambda a: dict(k_scale=None),
    "stray scales": lambda a: dict(k=a["k"].bfloat16(), v=a["v"].bfloat16()),
    "head dim": lambda a: dict(q=a["q"][..., :32].contiguous(),
                               k=a["k"][..., :32].contiguous(),
                               v=a["v"][..., :32].contiguous()),
    "group": lambda a: dict(q=torch.zeros((2, 2, 17, 64),
                                          dtype=torch.bfloat16)),
    "negative window": lambda a: dict(window=-1),
    "misaligned k": lambda a: dict(k=_misaligned(a["k"])),
    "non-contiguous v": lambda a: dict(
        v=a["v"].transpose(1, 2).contiguous().transpose(1, 2)),
    "k_pos on another device": lambda a: dict(k_pos=a["k_pos"].to("meta")),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_check_ring_refuses_what_the_kernels_do_not_take(case):
    """The wrappers' one-pass input check (``check_ring``, on CPU tensors)
    accepts the decode and verify inputs the kernels take and raises
    ValueError on each input they refuse."""
    for kq in (None, 4):
        da.check_ring(**_check_args(kq=kq))
        da.check_ring(**_check_args(quant=False, kq=kq))
    args = _check_args()
    args.update(REFUSED[case](args))
    with pytest.raises(ValueError):
        da.check_ring(**args)
