"""Tests of the port that need an NVIDIA GPU: the CUDA kernels (ring and
paged flash-decode, ring and paged speculative verify, the dither
quantiser and the dither matmul's two entries) against their plain
versions, paged == ring bit for bit, every verify row equal to the decode
kernel at its position bit for bit, the policy entry equal to the
torch-ops route around the f32 kernel bit for bit, the kernels' modulo over all 2^32
numerators, the wrappers' input checks, the serving path's launch
counts and streams, and decode windows replayed from CUDA graphs against
the same windows run eagerly, byte for byte; kernel 1 at head dim 256 and
the recurrent configs' scanned prefill replayed from its captured step;
the encoder-decoder's engine and train step; sharded serving with ranks
sharing the card (gloo); kernel 6's sharded entry against its plain
version and the training mesh's step through it.  They import torch and the port
only (the card's machine has no JAX) and skip where
``torch.cuda.is_available()`` is false:

  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import paged_verify_attention as pva
from repro_torch.kernels import ref
from repro_torch.kernels import verify_attention as va
from repro_torch.models import registry

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ring(seed, *, b, cap, nkv, group, hd, quant, pos_vals, device,
          kq=None):
    """A ring-cache snapshot: slot s of row i holds the latest position
    p ≡ s (mod cap) with p ≤ pos_i (pos_i + kq - 1 for a verify call, whose
    q is (B, kq, n_kv, group, hd)); unwritten slots carry k_pos = -1."""
    rng = np.random.default_rng(seed)
    kpos = np.full((b, cap), -1, np.int32)
    for i, p in enumerate(pos_vals):
        top = p + (kq or 1) - 1
        ps = np.arange(max(0, top - cap + 1), top + 1)
        kpos[i, ps % cap] = ps
    q = torch.from_numpy(rng.normal(
        size=(b,) + ((kq,) if kq else ()) + (nkv, group, hd)).astype(
        np.float32)).bfloat16()
    if quant:
        k, v = (torch.from_numpy(rng.integers(-127, 128, size=(
            b, cap, nkv, hd)).astype(np.int8)) for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.1, 2.0, size=(
            b, cap, nkv)).astype(np.float32)) for _ in range(2))
    else:
        k, v = (torch.from_numpy(rng.normal(size=(b, cap, nkv, hd)).astype(
            np.float32)).bfloat16() for _ in range(2))
        ks = vs = None
    out = [q, k, v, torch.from_numpy(kpos),
           torch.tensor(pos_vals, dtype=torch.int32), ks, vs]
    return [None if t is None else t.to(device) for t in out]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nkv,group,hd", [(3, 3, 64), (2, 6, 128),
                                          (4, 1, 64), (1, 16, 128)])
def test_kernel_matches_plain(cuda, quant, nkv, group, hd):
    """Kernel vs plain version with the same 64-slot block: a wrapped ring,
    a sliding window, a cap that is not a multiple of the block, f32
    allclose at 1e-4 (summation order only)."""
    for cap, window in ((256, 0), (256, 100), (96, 0)):
        t = _ring(group + cap, b=4, cap=cap, nkv=nkv, group=group, hd=hd,
                  quant=quant, pos_vals=[0, 70, cap - 1, 600], device=cuda)
        before = da.decode_attention.launches
        got = da.decode_attention(*t, window=window)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == before + 1
        want = ref.decode_attention_ref(*t, window=window,
                                        block=(da.KERNEL_BLOCK,))
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        split = ref.decode_attention_ref(*t, window=window,
                                         block=(da.KERNEL_BLOCK,),
                                         split=da.SPLIT_TILES)
        torch.testing.assert_close(got, split, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nkv,group,hd,kq", [(3, 3, 64, 4), (2, 6, 128, 8)])
def test_kernels_at_split_boundaries(cuda, quant, nkv, group, hd, kq):
    """Rows either side of the first two split boundaries (multiples of
    SPLIT_TILES tiles of 64 keys) and of the ring's end (1023/1024/1025)
    in a 1024-slot ring: decode and verify (K 4 at SmolLM-135M's heads, K 8 at
    Qwen2-1.5B's: 48 rows a block) against the plain version with the same
    tiles and split and against the whole-cap plain version, at 1e-4, and
    every verify row equal to the decode kernel at its position, bit for
    bit."""
    span = da.KERNEL_BLOCK * da.SPLIT_TILES
    pos_vals = [span - 1, span, span + 1, 2 * span - 1, 2 * span, 1023, 1024,
                1025]
    kw = dict(block=(da.KERNEL_BLOCK,), split=da.SPLIT_TILES)
    t = _ring(11 + kq, b=8, cap=1024, nkv=nkv, group=group, hd=hd,
              quant=quant, pos_vals=pos_vals, device=cuda)
    got = da.decode_attention(*t)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref.decode_attention_ref(*t, **kw),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got, ref.decode_attention_ref(*t), atol=1e-4,
                               rtol=1e-4)
    t = _ring(12 + kq, b=8, cap=1024, nkv=nkv, group=group, hd=hd,
              quant=quant, pos_vals=[p - 2 for p in pos_vals], kq=kq,
              device=cuda)
    got = va.verify_attention(*t)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref.verify_attention_ref(*t, **kw),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got, ref.verify_attention_ref(*t), atol=1e-4,
                               rtol=1e-4)
    _rows_equal_decode(got, da.decode_attention, t, 0)


def test_fully_masked_row_matches_plain(cuda):
    t = _ring(1, b=2, cap=128, nkv=3, group=3, hd=64, quant=False,
              pos_vals=[5, 200], device=cuda)
    t[3].fill_(-1)
    got = da.decode_attention(*t)
    want = ref.decode_attention_ref(*t, block=(da.KERNEL_BLOCK,))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    t = _ring(2, b=2, cap=128, nkv=2, group=2, hd=64, quant=True,
              pos_vals=[5, 9], device=cuda)
    q, k, v, kp, pos, ks, vs = t
    bad = [
        dict(q=q.float()),                                  # dtype
        dict(k_scale=None),                                 # int8 w/o scales
        dict(k_pos=kp.long()),                              # index dtype
        dict(k=k[:, :, :, :32].contiguous(),
             v=v[:, :, :, :32].contiguous(), q=q[..., :32].contiguous()),
        dict(v=v.transpose(1, 2).contiguous().transpose(1, 2)),  # layout
        dict(pos=pos.cpu()),                                # device
    ]
    base = dict(q=q, k=k, v=v, k_pos=kp, pos=pos, k_scale=ks, v_scale=vs)
    for change in bad:
        args = {**base, **change}
        with pytest.raises(ValueError):
            da.decode_attention(args["q"], args["k"], args["v"],
                                args["k_pos"], args["pos"], args["k_scale"],
                                args["v_scale"])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_step_launches_once_per_layer(cuda, kv_quant):
    """A decode step of the reduced model runs the kernel once per layer,
    and its logits agree with the plain-version backend."""
    # the reduced model with the kernel's head dim (it takes 64 and 128)
    cfg = dataclasses.replace(get_config("smollm_135m").reduced(),
                              n_heads=6, n_kv_heads=2, head_dim=64)
    params = registry.init_model(cfg, seed=0, device=cuda)
    toks = torch.randint(1, cfg.vocab_size, (4, 24), device=cuda)
    lens = torch.tensor([24, 10, 3, 17], dtype=torch.int32, device=cuda)
    _, cache = registry.apply_prefill(params, cfg, toks, lens, 64,
                                      kv_quant=kv_quant)
    ref_cache = copy.deepcopy(cache)
    cur = torch.tensor([1, 2, 3, 4], device=cuda)
    before = da.decode_attention.launches
    got, _ = registry.apply_decode(params, cfg, cur, cache)
    assert da.decode_attention.launches == before + cfg.n_layers
    want, _ = registry.apply_decode(params, cfg, cur, ref_cache,
                                    backend="torch-ref")
    assert da.decode_attention.launches == before + cfg.n_layers
    torch.testing.assert_close(got, want, atol=2.0 ** -5, rtol=0)


def _pool(seed, *, b, bs, nbmax, nkv, group, hd, quant, pos_vals, device,
          share=False, kq=None):
    """A paged pool: each row's blocks drawn in a shuffled order, row 1
    sharing row 0's first two blocks when ``share``, unused table entries
    on the trailing trash block; with ``kq`` (a verify call) q is
    (B, kq, n_kv, group, hd) and rows hold blocks up to pos_i + kq - 1."""
    rng = np.random.default_rng(seed)
    nblk = b * nbmax + 1
    if quant:
        k, v = (torch.from_numpy(rng.integers(-127, 128, size=(
            nblk, bs, nkv, hd)).astype(np.int8)) for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.1, 2.0, size=(
            nblk, bs, nkv)).astype(np.float32)) for _ in range(2))
    else:
        k, v = (torch.from_numpy(rng.normal(size=(nblk, bs, nkv, hd)).astype(
            np.float32)).bfloat16() for _ in range(2))
        ks = vs = None
    q = torch.from_numpy(rng.normal(
        size=(b,) + ((kq,) if kq else ()) + (nkv, group, hd)).astype(
        np.float32)).bfloat16()
    ids = list(rng.permutation(nblk - 1))
    bt = np.full((b, nbmax), nblk - 1, np.int32)
    for i, p in enumerate(pos_vals):
        for j in range(min((p + (kq or 1) - 1) // bs, nbmax - 1) + 1):
            bt[i, j] = bt[0, j] if share and i == 1 and j < 2 else ids.pop()
    out = [q, k, v, torch.from_numpy(bt),
           torch.tensor(pos_vals, dtype=torch.int32), ks, vs]
    return [None if t is None else t.to(device) for t in out]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nkv,group,hd", [(3, 3, 64), (2, 6, 128),
                                          (4, 1, 64), (1, 16, 128)])
def test_paged_kernel_matches_plain(cuda, quant, nkv, group, hd):
    """Paged kernel vs its plain version: block sizes 64, 16 and 5, a
    sliding window, shared prefix blocks, an idle row on the trash block;
    f32 allclose at 1e-4 (summation order only)."""
    for bs, window in ((64, 0), (16, 100), (5, 0)):
        t = _pool(group + bs, b=4, bs=bs, nbmax=-(-640 // bs), nkv=nkv,
                  group=group, hd=hd, quant=quant, pos_vals=[0, 70, 639, 0],
                  device=cuda, share=True)
        t[3][3].fill_(t[1].shape[0] - 1)                 # idle row: trash
        before = pda.paged_decode_attention.launches
        got = pda.paged_decode_attention(*t, window=window)
        torch.cuda.synchronize()
        assert pda.paged_decode_attention.launches == before + 1
        want = ref.paged_decode_attention_ref(*t, window=window)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 100])
def test_paged_kernel_bitwise_equals_ring_kernel(cuda, quant, window):
    """The same token stream in a ring (no wrap) and in a pool of 64-token
    blocks: the two kernels share one tile body, so at bs == bk == 64 their
    outputs are equal bit for bit."""
    b, cap, nkv, group, hd, bs = 4, 512, 3, 3, 64, da.KERNEL_BLOCK
    t = _ring(5, b=b, cap=cap, nkv=nkv, group=group, hd=hd, quant=quant,
              pos_vals=[0, 70, 300, 511], device=cuda)
    q, k, v, kp, pos, ks, vs = t
    nbmax = cap // bs
    perm = torch.randperm(b * nbmax, generator=torch.Generator().manual_seed(
        0)).to(cuda)
    bt = perm.reshape(b, nbmax).to(torch.int32)

    def to_pool(x):
        pool = torch.zeros((b * nbmax + 1, bs) + tuple(x.shape[2:]),
                           dtype=x.dtype, device=cuda)
        pool[perm] = x.reshape((b * nbmax, bs) + tuple(x.shape[2:]))
        return pool

    ring = da.decode_attention(*t, window=window)
    paged = pda.paged_decode_attention(
        q, to_pool(k), to_pool(v), bt, pos,
        None if ks is None else to_pool(ks),
        None if vs is None else to_pool(vs), window=window)
    torch.cuda.synchronize()
    assert torch.equal(ring, paged)


def test_paged_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    t = _pool(3, b=2, bs=16, nbmax=4, nkv=2, group=2, hd=64, quant=True,
              pos_vals=[5, 40], device=cuda)
    q, k, v, bt, pos, ks, vs = t
    big = _pool(3, b=2, bs=128, nbmax=2, nkv=2, group=2, hd=64, quant=False,
                pos_vals=[5, 40], device=cuda)
    with pytest.raises(ValueError, match=r"not in \[1, 64\]"):
        pda.paged_decode_attention(*big)
    bad = [dict(q=q.float()), dict(k_scale=None), dict(bt=bt.long()),
           dict(pos=pos.cpu()), dict(bt=bt.t().contiguous().t())]
    base = dict(q=q, k=k, v=v, bt=bt, pos=pos, k_scale=ks, v_scale=vs)
    for change in bad:
        a = {**base, **change}
        with pytest.raises(ValueError):
            pda.paged_decode_attention(a["q"], a["k"], a["v"], a["bt"],
                                       a["pos"], a["k_scale"], a["v_scale"])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_engine_launches_once_per_layer_per_tick(cuda, kv_quant):
    """The paged engine on the card decodes through the paged kernel only,
    once per layer per tick, and its greedy streams equal the ring
    engine's at 64-token pool blocks (the ring kernel's default tile at
    this cap; the default pool block at max_len 128 is 32 since the
    autotuner gives the reference's rule, so the block is given).
    Every tick is a CUDA-graph replay: the launches are the captured
    graph's (one per layer) times its replays, one replay per tick; the
    host count saw only the warm-up's launches and the capture's."""
    from repro_torch.serve import Engine, Request

    cfg = dataclasses.replace(get_config("smollm_135m").reduced(),
                              n_heads=6, n_kv_heads=2, head_dim=64)
    params = registry.init_model(cfg, seed=0, device=cuda)
    streams = {}
    for layout in ("ring", "paged"):
        eng = Engine(params, cfg, 2, 128, kv_quant=kv_quant,
                     kv_layout=layout, device=cuda,
                     block_size=64 if layout == "paged" else None)
        for r in range(3):
            eng.submit(Request(rid=r, prompt=[1 + r, 2, 3, 4, 5] * (r + 1),
                               max_new=6))
        pda.paged_decode_attention.launches = 0
        da.decode_attention.launches = 0
        done = eng.run(100)
        streams[layout] = [r.out for r in sorted(done, key=lambda r: r.rid)]
        ticks = eng.stats["decode_calls"]
        graphs = eng._graphs
        assert graphs.replays == ticks
        name = ("paged_decode_attention" if layout == "paged"
                else "decode_attention")
        other = ("decode_attention" if layout == "paged"
                 else "paged_decode_attention")
        assert graphs.launches()[name] == cfg.n_layers * ticks
        assert graphs.launches()[other] == 0
        host = {"decode_attention": da.decode_attention.launches,
                "paged_decode_attention":
                    pda.paged_decode_attention.launches}
        assert host[name] == 2 * graphs.recorded()[name] == 2 * cfg.n_layers
        assert host[other] == 0
        if layout == "paged":
            assert eng.pool.live_blocks == 0
    assert streams["paged"] == streams["ring"]


# ---------------------------------------------------------------------------
# speculative verify kernels
# ---------------------------------------------------------------------------


def _rows_equal_decode(got, decode, t, window):
    """Verify row r against ``decode`` at pos + r, bit for bit."""
    q, k, v, index, pos, ks, vs = t
    for r in range(q.shape[1]):
        one = decode(q[:, r].contiguous(), k, v, index, pos + r, ks, vs,
                     window=window)
        torch.cuda.synchronize()
        assert torch.equal(got[:, r], one), r


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nkv,group,hd,kq", [(3, 3, 64, 4), (2, 6, 128, 4),
                                             (2, 6, 128, 8), (1, 16, 128, 3)])
def test_verify_kernel_matches_plain_and_decode_rows(cuda, quant, nkv, group,
                                                     hd, kq):
    """Ring verify kernel vs its plain version (64-slot blocks) at 1e-4, and
    every row equal to the ring decode kernel at pos + t bit for bit: a
    wrapped ring, a window, a cap that is not a multiple of the block, and
    a slot at cap - 2 whose last rows run past the ring's end."""
    for cap, window in ((256, 0), (256, 100), (96, 0)):
        t = _ring(group + cap + kq, b=5, cap=cap, nkv=nkv, group=group, hd=hd,
                  quant=quant, pos_vals=[0, 70, cap - 2, 600, 5], kq=kq,
                  device=cuda)
        before = va.verify_attention.launches
        got = va.verify_attention(*t, window=window)
        torch.cuda.synchronize()
        assert va.verify_attention.launches == before + 1
        want = ref.verify_attention_ref(*t, window=window,
                                        block=(da.KERNEL_BLOCK,))
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        split = ref.verify_attention_ref(*t, window=window,
                                         block=(da.KERNEL_BLOCK,),
                                         split=da.SPLIT_TILES)
        torch.testing.assert_close(got, split, atol=1e-4, rtol=1e-4)
        _rows_equal_decode(got, da.decode_attention, t, window)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nkv,group,hd,kq", [(3, 3, 64, 4), (2, 6, 128, 8),
                                             (1, 16, 128, 3)])
def test_paged_verify_kernel_matches_plain_and_decode_rows(cuda, quant, nkv,
                                                           group, hd, kq):
    """Paged verify kernel vs its plain version at 1e-4 and every row equal
    to the paged decode kernel at pos + t bit for bit: blocks of 64, 16
    and 5 tokens, a window, shared prefix blocks, an idle row on the trash
    block, and a slot two short of the table's end."""
    for bs, window in ((64, 0), (16, 100), (5, 0)):
        nbmax = -(-640 // bs)
        t = _pool(group + bs + kq, b=5, bs=bs, nbmax=nbmax, nkv=nkv,
                  group=group, hd=hd, quant=quant,
                  pos_vals=[0, 70, nbmax * bs - 2, 0, 300], device=cuda,
                  share=True, kq=kq)
        t[3][3].fill_(t[1].shape[0] - 1)                 # idle row: trash
        before = pva.paged_verify_attention.launches
        got = pva.paged_verify_attention(*t, window=window)
        torch.cuda.synchronize()
        assert pva.paged_verify_attention.launches == before + 1
        want = ref.paged_verify_attention_ref(*t, window=window)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        _rows_equal_decode(got, pda.paged_decode_attention, t, window)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 100])
def test_paged_verify_bitwise_equals_ring_verify(cuda, quant, window):
    """One token stream in a ring (no wrap) and in 64-token pool blocks:
    paged verify equals ring verify bit for bit, as the decode kernels
    do."""
    b, cap, nkv, group, hd, bs, kq = 4, 512, 3, 3, 64, da.KERNEL_BLOCK, 4
    t = _ring(6, b=b, cap=cap, nkv=nkv, group=group, hd=hd, quant=quant,
              pos_vals=[0, 70, 300, 508], device=cuda, kq=kq)
    q, k, v, kp, pos, ks, vs = t
    nbmax = cap // bs
    perm = torch.randperm(b * nbmax, generator=torch.Generator().manual_seed(
        1)).to(cuda)
    bt = perm.reshape(b, nbmax).to(torch.int32)

    def to_pool(x):
        if x is None:
            return None
        pool = torch.zeros((b * nbmax + 1, bs) + tuple(x.shape[2:]),
                           dtype=x.dtype, device=cuda)
        pool[perm] = x.reshape((b * nbmax, bs) + tuple(x.shape[2:]))
        return pool

    ring = va.verify_attention(*t, window=window)
    paged = pva.paged_verify_attention(q, to_pool(k), to_pool(v), bt, pos,
                                       to_pool(ks), to_pool(vs),
                                       window=window)
    torch.cuda.synchronize()
    assert torch.equal(ring, paged)


def test_verify_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v, kp, pos, ks, vs = _ring(7, b=2, cap=128, nkv=2, group=2, hd=64,
                                     quant=True, pos_vals=[5, 9], kq=4,
                                     device=cuda)
    bad = [dict(q=q.float()), dict(q=q[:, 0].contiguous()),
           dict(q=q.transpose(1, 2).contiguous().transpose(1, 2)),
           dict(k_scale=None), dict(k_pos=kp.long()), dict(pos=pos.cpu()),
           dict(q=q[..., :32].contiguous(), k=k[..., :32].contiguous(),
                v=v[..., :32].contiguous())]
    base = dict(q=q, k=k, v=v, k_pos=kp, pos=pos, k_scale=ks, v_scale=vs)
    for change in bad:
        a = {**base, **change}
        with pytest.raises(ValueError):
            va.verify_attention(a["q"], a["k"], a["v"], a["k_pos"], a["pos"],
                                a["k_scale"], a["v_scale"])
    t = _pool(8, b=2, bs=16, nbmax=4, nkv=2, group=2, hd=64, quant=False,
              pos_vals=[5, 40], kq=3, device=cuda)
    q, k, v, bt, pos, _, _ = t
    big = _pool(8, b=2, bs=128, nbmax=2, nkv=2, group=2, hd=64, quant=False,
                pos_vals=[5, 40], kq=3, device=cuda)
    with pytest.raises(ValueError, match=r"not in \[1, 64\]"):
        pva.paged_verify_attention(*big)
    for change in (dict(q=q[:, 0].contiguous()), dict(bt=bt.long()),
                   dict(q=q.float())):
        a = {**dict(q=q, bt=bt), **change}
        with pytest.raises(ValueError):
            pva.paged_verify_attention(a["q"], k, v, a["bt"], pos)
    with pytest.raises(ValueError):                 # a 5-D q to decode
        pda.paged_decode_attention(q, k, v, bt, pos)


def _hd64_config():
    """The reduced model with the kernels' head dim (they take 64 and 128)."""
    return dataclasses.replace(get_config("smollm_135m").reduced(),
                               n_heads=6, n_kv_heads=2, head_dim=64)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_verify_step_rows_equal_decode_steps_on_the_card(cuda, kv_quant,
                                                         layout):
    """A verify step runs its layout's verify kernel once per layer, and
    its row t is bit for bit the decode step at pos + t after the drafts
    before it: the row purity the speculative stream rests on."""
    from repro_torch.models import transformer

    cfg = _hd64_config()
    params = registry.init_model(cfg, seed=0, device=cuda)
    kw = (dict(kv_layout="paged", block_size=16, num_blocks=24)
          if layout == "paged" else {})
    toks = torch.randint(1, cfg.vocab_size, (4, 24), device=cuda)
    lens = torch.tensor([24, 10, 3, 17], dtype=torch.int32, device=cuda)
    off = torch.tensor([0, 7, 1000, 3], dtype=torch.int32, device=cuda)
    cache = registry.make_cache(params, cfg, 4, 64, kv_quant=kv_quant,
                                device=cuda, **kw)
    if layout == "paged":
        bt = torch.arange(16, dtype=torch.int32, device=cuda).reshape(4, 4)
        _, cache = registry.apply_prefill_paged(
            params, cfg, toks, lens, torch.zeros_like(lens), bt, cache,
            kv_quant=kv_quant, kv_offset=off)
    else:
        _, pf = registry.apply_prefill(params, cfg, toks, lens, 64,
                                       kv_quant=kv_quant, kv_offset=off)
        cache = registry.merge_prefill(cfg, cache, pf, lens > 0)
    seq_cache = copy.deepcopy(cache)
    drafts = torch.randint(1, cfg.vocab_size, (4, 4), device=cuda)
    kernel = pva.paged_verify_attention if layout == "paged" \
        else va.verify_attention
    before = kernel.launches
    logits, _ = registry.apply_verify(params, cfg, drafts, cache,
                                      kv_offset=off)
    torch.cuda.synchronize()
    assert kernel.launches == before + cfg.n_layers
    for t in range(4):
        want, seq_cache = registry.apply_decode(params, cfg, drafts[:, t],
                                                seq_cache, kv_offset=off)
        torch.cuda.synchronize()
        assert torch.equal(logits[:, t], want), t


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_spec_engine_streams_equal_plain_on_the_card(cuda, kv_quant, layout):
    """The speculative engine on the card: greedy and sampled streams equal
    the plain engine's token for token, with a replay drafter (most drafts
    accepted) and the default prompt lookup; one verify launch per layer
    per window and no decode-kernel launch."""
    from repro_torch.serve import Engine, Request, SamplingParams
    from repro_torch.serve.draft import ReplayDrafter

    cfg = _hd64_config()
    params = registry.init_model(cfg, seed=0, device=cuda)
    kw = dict(kv_layout="paged", block_size=8) if layout == "paged" else {}

    def serve(**spec):
        eng = Engine(params, cfg, 2, 64, kv_quant=kv_quant, device=cuda,
                     **kw, **spec)
        for r in range(3):
            eng.submit(Request(rid=r, prompt=[1 + r, 2, 3, 4, 5] * (r + 1),
                               sampling=SamplingParams(
                                   temperature=0.8 * (r % 2), top_k=20,
                                   seed=r, max_new=9,
                                   counter_offset=100 * r)))
        for m in (da.decode_attention, pda.paged_decode_attention,
                  va.verify_attention, pva.paged_verify_attention):
            m.launches = 0
        done = sorted(eng.run(200), key=lambda r: r.rid)
        return eng, {tuple(r.prompt): r.out for r in done}

    _, plain = serve()
    for drafter in (ReplayDrafter(plain), None):
        eng, spec = serve(spec_decode=True, draft_k=4, drafter=drafter)
        assert spec == plain
        windows = eng.stats["spec_windows"]
        kernel = pva.paged_verify_attention if layout == "paged" \
            else va.verify_attention
        assert kernel.launches == cfg.n_layers * windows > 0
        assert da.decode_attention.launches == 0
        assert pda.paged_decode_attention.launches == 0
        if drafter is not None:
            assert eng.stats["spec_accepted_tokens"] > 0
        if layout == "paged":
            assert eng.pool.live_blocks == 0


# ---------------------------------------------------------------------------
# kernels 5–6: the quantiser and the quantise-and-multiply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["spread", "unary"])
@pytest.mark.parametrize("scheme", ["deterministic", "stochastic", "dither"])
def test_quantize_kernel_matches_plain_bitwise(cuda, scheme, fmt):
    """The CUDA quantiser's int32 codes equal the plain version's bit for
    bit: the serve path's operand shapes and a ragged one, bits 1–16,
    counters and seeds past 2^31."""
    from repro_torch.kernels import quantize as qk

    gen = torch.Generator().manual_seed(0)
    for shape in ((8, 576), (576, 1536), (37, 1000), (1, 3)):
        x = (torch.rand(shape, generator=gen) * 2.6 - 1.3).to(cuda)
        for bits, counter, seed, n in ((8, 0, 1, 16), (4, 2**31 + 9, 7, 576),
                                       (2, 5, 2**32 - 1, 3), (16, 77, 3, 49),
                                       (1, 1, 0, 2)):
            kw = dict(scale=((1 << bits) - 1) / 2.0, zero=-1.0, bits=bits,
                      scheme=scheme, counter=counter, seed=seed, n_pulses=n,
                      fmt=fmt)
            before = qk.quantize.launches
            got = qk.quantize(x, **kw)
            torch.cuda.synchronize()
            assert qk.quantize.launches == before + 1
            assert torch.equal(got, ref.quantize_codes_ref(x, **kw)), (
                shape, bits, counter)


@pytest.mark.parametrize("scheme", ["deterministic", "stochastic", "dither"])
def test_dither_matmul_kernel_matches_plain_bitwise(cuda, scheme):
    """The CUDA dither matmul equals the plain version bit for bit (both
    exact integer products, the same epilogue): decode and prefill shapes
    of the serve path, ragged shapes off every tile multiple, signed and
    unsigned ranges, bits 1–8, both pulse formats."""
    from repro_torch.kernels import dither_matmul as dm

    gen = torch.Generator().manual_seed(1)
    for (m, k, n) in ((8, 576, 576), (8, 1536, 576), (8, 576, 49152),
                      (512, 576, 1536), (37, 100, 53), (5, 7, 3),
                      (129, 65, 130)):
        a = (torch.rand((m, k), generator=gen) * 2 - 1).to(cuda)
        b = (torch.rand((k, n), generator=gen) * 2 - 1).to(cuda)
        for rg, bits, fmt in (((-1.0, 1.0), 8, "spread"),
                              ((0.0, 1.0), 4, "unary"),
                              ((-0.7, 1.3), 1, "spread")):
            kw = dict(bits=bits, scheme=scheme, a_range=rg, b_range=rg,
                      counter=41, seed=6, fmt=fmt)
            before = dm.dither_matmul.launches
            got = dm.dither_matmul(a, b, **kw)
            torch.cuda.synchronize()
            assert dm.dither_matmul.launches == before + 1
            want = ref.dither_matmul_ref(a, b, **kw)
            assert torch.equal(got, want), ((m, k, n), rg, bits,
                                            (got - want).abs().max().item())


def test_dither_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels import dither_matmul as dm
    from repro_torch.kernels import quantize as qk

    a = torch.rand((8, 64), device=cuda)
    b = torch.rand((64, 16), device=cuda)
    kw = dict(bits=8, scheme="dither", counter=0, seed=0)
    for bad_a, bad_b, bad_kw in ((a.half(), b, {}), (a, b.T.contiguous().T, {}),
                                 (a, b[:32], {}), (a, b, {"bits": 9}),
                                 (a, b, {"scheme": "bogus"}),
                                 (a, b.cpu(), {})):
        with pytest.raises(ValueError):
            dm.dither_matmul(bad_a, bad_b, **{**kw, **bad_kw})
    with pytest.raises(ValueError, match="int32 accumulator"):
        dm.dither_matmul(torch.rand((2, 33100), device=cuda),
                         torch.rand((33100, 2), device=cuda), **kw)
    qkw = dict(scale=255.0, zero=0.0, bits=8, scheme="dither", counter=0,
               seed=0, n_pulses=16)
    for bad in (a.half(), a[:, ::2], a[None]):
        with pytest.raises(ValueError):
            qk.quantize(bad, **qkw)
    with pytest.raises(ValueError):
        qk.quantize(a, **{**qkw, "bits": 17})


def _torch_ops_route(x, w, **kw):
    """The policy's product the way ``_fused_matmul`` computes it for
    operands the policy entry does not take: torch ops for the
    absmaxes, the normalised f32 operands and the rescale around the f32
    CUDA kernel."""
    from repro_torch.kernels import dispatch

    ax = torch.clamp_min(torch.amax(torch.abs(x)), 1e-6)
    aw = torch.clamp_min(torch.amax(torch.abs(w)), 1e-6)
    out = dispatch.matmul((x / ax).to(torch.float32),
                          (w / aw).to(torch.float32), a_range=(-1.0, 1.0),
                          b_range=(-1.0, 1.0), backend="cuda", **kw)
    return (out * (ax * aw)).to(x.dtype)


@pytest.mark.parametrize("scheme", ["deterministic", "stochastic", "dither"])
def test_policy_entry_matches_the_torch_ops_route_bitwise(cuda, scheme):
    """The dither matmul's policy entry equals the torch-ops route (torch ops
    around the f32 kernel, on the card: torch's bf16 division by a 0-dim
    CUDA tensor and its f32 rescale) and the plain version bit for bit: the
    serve path's decode shapes with the tied LM head as a transposed view,
    a 4096-row prefill, the regime boundary M = 128 / 129 in both weight
    layouts, K-split remainders and ragged shapes; and ``_fused_matmul``
    takes it for bf16 operands, one launch a product."""
    from repro_torch.kernels import dither_matmul as dm
    from repro_torch.numerics import policy

    gen = torch.Generator().manual_seed(2)
    cases = [(8, 576, 576, False), (8, 576, 192, False),
             (8, 576, 1536, False), (8, 1536, 576, False),
             (8, 576, 49152, True), (4096, 576, 1536, False),
             (128, 576, 200, False), (128, 576, 200, True),
             (129, 576, 200, False), (129, 576, 200, True),
             (8, 600, 576, False), (8, 1000, 192, True), (37, 100, 53, True),
             (5, 7, 3, False), (1, 33, 17, True)]
    for m, k, n, trans in cases:
        x = torch.randn((m, k), generator=gen).bfloat16().to(cuda)
        w = (torch.randn((n, k) if trans else (k, n), generator=gen)
             * 0.05).bfloat16().to(cuda)
        w = w.T if trans else w
        for counter, seed in ((3, 1), (2 ** 31 + 5, 9)):
            kw = dict(bits=8, scheme=scheme, counter=counter, seed=seed)
            before = (dm.dither_matmul.launches,
                      dm.dither_matmul_scaled.launches)
            got = dm.dither_matmul_scaled(x, w, dm.weight_absmax(w), **kw)
            torch.cuda.synchronize()
            assert (dm.dither_matmul.launches,
                    dm.dither_matmul_scaled.launches) == (before[0] + 1,
                                                          before[1] + 1)
            want = _torch_ops_route(x, w, **kw)
            assert torch.equal(got, want), ((m, k, n, trans), (
                got.float() - want.float()).abs().max().item())
            assert torch.equal(got, ref.dither_matmul_scaled_ref(x, w, **kw))
        pol = policy.QuantPolicy(scheme=scheme, backend="cuda")
        before = dm.dither_matmul_scaled.launches
        via = policy._fused_matmul(x, w, pol, seed, float(counter))
        assert dm.dither_matmul_scaled.launches == before + 1
        assert torch.equal(via, got)


def test_decode_split_scratch_returns_to_zero(cuda):
    """The decode regime's split merge leaves its partial sums, column sums
    and arrival counters at 0 after every call, so the next call starts
    clean: repeated products give the same bits."""
    from repro_torch.kernels import dither_matmul as dm

    gen = torch.Generator().manual_seed(3)
    a = (torch.rand((8, 576), generator=gen) * 2 - 1).to(cuda)
    for n in (576, 192, 1536):
        assert dm.plan(8, 576, n)["splits"] > 1
        b = (torch.rand((576, n), generator=gen) * 2 - 1).to(cuda)
        kw = dict(bits=8, scheme="dither", a_range=(-1.0, 1.0),
                  b_range=(-1.0, 1.0), counter=7, seed=2)
        outs = [dm.dither_matmul(a, b, **kw) for _ in range(3)]
        torch.cuda.synchronize()
        assert all(torch.equal(o, outs[0]) for o in outs)
        assert torch.equal(outs[0], ref.dither_matmul_ref(a, b, **kw))
    for s in dm._SCRATCH.values():
        for name in ("acc", "colacc", "arrivals"):
            if name in s.bufs:
                assert not s.bufs[name].any(), name


def test_modulo_magic_exhaustive(cuda):
    """The kernels' multiply-high ``x % N`` (``dither_quant.cuh:mod_n``)
    equals ``%`` for all 2^32 uint32 numerators, at the serve path's pulse
    counts and odd divisors up to 2^32 − 1."""
    from repro_torch.kernels import quantize as qk

    for d in (2, 3, 7, 192, 576, 1536, 49152, 641, 2 ** 31 - 1, 2 ** 31 + 1,
              2 ** 32 - 1):
        assert qk.fastmod_mismatches(d) == 0, d


@pytest.mark.parametrize("scheme", ["deterministic", "stochastic", "dither"])
def test_quantize_kernel_far_outside_the_range(cuda, scheme):
    """Values whose scaled code lies far outside [0, 2^bits − 1] (past
    2^22, where the kernels' fast floor no longer is floor, and at ±inf)
    clip as the plain version's do, and pulse counts above 2^22 take the
    general path: the plain version's codes bit for bit."""
    from repro_torch.kernels import quantize as qk

    vals = torch.tensor([[0.0, -0.0, 1e-30, -1e-30, 0.5, 4194303.5, 4194304.0,
                          4194304.5, -4194304.5, 8388609.0, 1e7, -1e7, 1e30,
                          -1e30, 3e38, -3e38, float("inf"), float("-inf")]])
    x = torch.cat([vals, vals / 127.5 - 1.0], 0).to(cuda)
    for n_pulses in (16, 49152, 2 ** 22, 2 ** 22 + 1, 2 ** 23 + 5):
        kw = dict(scale=127.5, zero=-1.0, bits=8, scheme=scheme, counter=3,
                  seed=1, n_pulses=n_pulses)
        got = qk.quantize(x, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.quantize_codes_ref(x, **kw)), n_pulses


def test_reciprocal_normalisation_is_the_division(cuda):
    """The policy entry's normalisation by a reciprocal (three instructions
    in place of an IEEE division) gives ``bf16(x / absmax)`` bit for bit
    for every bf16 x with |x| <= absmax and every finite bf16 absmax >=
    bf16(1e-6) — the only pairs the kernel meets, since absmax is the
    clamped max |x| of x's own weight — out of all 1.24e9 pairs, on the
    card."""
    from repro_torch.kernels import dither_matmul as dm

    in_range, everywhere = dm.normalise_mismatches(cuda)
    assert in_range == 0, (in_range, everywhere)


def test_quantize_kernel_unaligned_and_ragged(cuda):
    """Kernel 5 on a tensor whose storage is not 16-byte aligned (one
    element at a time) and on element counts off a multiple of 4 (the
    vector path's tail): the plain version's codes bit for bit."""
    from repro_torch.kernels import quantize as qk

    gen = torch.Generator().manual_seed(4)
    big = (torch.rand(40_001, generator=gen) * 2.6 - 1.3).to(cuda)
    kw = dict(scale=127.5, zero=-1.0, bits=8, scheme="dither", counter=9,
              seed=3, n_pulses=576)
    for x in (big[1:].view(200, 200), big[:39_999].view(3, 13_333),
              big[:7].view(1, 7), big[1:7].view(2, 3)):
        got = qk.quantize(x, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.quantize_codes_ref(x, **kw))


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_policy_forward_on_the_card(cuda, kv_quant, layout):
    """Under the dither policy a prefill and a decode step run the CUDA
    dither matmul once per dense product (7 per layer + the LM head), and
    their logits equal the plain-version matmul backend's bit for bit (the
    attention kernels shared)."""
    from repro_torch.kernels import dither_matmul as dm
    from repro_torch.numerics.policy import QuantPolicy

    cfg = _hd64_config()
    params = registry.init_model(cfg, seed=0, device=cuda)
    toks = torch.randint(1, cfg.vocab_size, (4, 24), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(0))
    lens = torch.tensor([24, 10, 3, 17], dtype=torch.int32, device=cuda)
    out = {}
    for backend in ("cuda", "torch-ref"):
        pol = QuantPolicy(scheme="dither", backend=backend)
        dm.dither_matmul.launches = 0
        if layout == "paged":
            cache = registry.make_cache(params, cfg, 4, 64, kv_quant=kv_quant,
                                        kv_layout="paged", block_size=8,
                                        device=cuda)
            bt = torch.arange(32, dtype=torch.int32,
                              device=cuda).reshape(4, 8)
            pf, cache = registry.apply_prefill_paged(
                params, cfg, toks, lens, torch.zeros_like(lens), bt, cache,
                policy=pol, counter=3, kv_quant=kv_quant)
        else:
            pf, cache = registry.apply_prefill(params, cfg, toks, lens, 64,
                                               policy=pol, counter=3,
                                               kv_quant=kv_quant)
        dec, _ = registry.apply_decode(params, cfg, torch.argmax(pf, -1),
                                       cache, policy=pol, counter=4)
        torch.cuda.synchronize()
        per_forward = 7 * cfg.n_layers + 1
        assert dm.dither_matmul.launches == (2 * per_forward
                                             if backend == "cuda" else 0)
        out[backend] = (pf, dec)
    for got, want in zip(out["cuda"], out["torch-ref"]):
        assert torch.equal(got, want)


def test_policy_engine_on_the_card(cuda):
    """The dither-policy engine on the card: every budget emitted, dither
    matmul launches = (7 per layer + 1) × (prefill calls + ticks), one
    prefill call per wave, and a restart replays the streams."""
    from repro_torch.kernels import dither_matmul as dm
    from repro_torch.numerics.policy import QuantPolicy
    from repro_torch.serve import Engine, Request, SamplingParams

    cfg = _hd64_config()
    params = registry.init_model(cfg, seed=0, device=cuda)

    def serve():
        eng = Engine(params, cfg, 2, 64, kv_quant=True, device=cuda,
                     policy=QuantPolicy(scheme="dither", backend="auto"))
        for r in range(3):
            eng.submit(Request(rid=r, prompt=[1 + r, 2, 3, 4, 5] * (r + 1),
                               sampling=SamplingParams(
                                   temperature=0.8 * (r % 2), top_k=20,
                                   seed=r, max_new=7)))
        dm.dither_matmul.launches = 0
        done = sorted(eng.run(200), key=lambda r: r.rid)
        torch.cuda.synchronize()
        st = eng.stats
        assert eng.policy.backend == "cuda"
        assert [len(r.out) for r in done] == [7, 7, 7]
        assert dm.dither_matmul.launches == (7 * cfg.n_layers + 1) * (
            st["prefill_calls"] + st["decode_calls"])
        return [r.out for r in done]

    assert serve() == serve()


# ---------------------------------------------------------------------------
# decode windows as CUDA-graph replays
# ---------------------------------------------------------------------------


def _clone(x):
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_clone(v) for v in x]
    return x.clone()


def _window_engine(cuda, layout, kv_quant, n):
    from repro_torch.serve import Engine, Request, SamplingParams

    cfg = _hd64_config()
    params = registry.init_model(cfg, seed=0, device=cuda)
    kw = (dict(kv_layout="paged", block_size=16, num_blocks=40)
          if layout == "paged" else {})
    eng = Engine(params, cfg, 4, 128, kv_quant=kv_quant, device=cuda,
                 decode_ticks=n, **kw)
    rng = np.random.default_rng(0)
    for r in range(7):
        eng.submit(Request(rid=r, prompt=rng.integers(
            1, cfg.vocab_size, size=int(rng.integers(5, 40))).tolist(),
            sampling=SamplingParams(temperature=0.8 * (r % 2), top_k=20,
                                    seed=r, max_new=5 + 3 * r,
                                    counter_offset=100 * r)))
    return cfg, params, eng


def _graph_against_eager(eng, cfg, params):
    """Run the engine's next window as a replay and the eager window on a
    clone of the state it starts from; both must leave the same bytes
    (the paged pool's trash block aside: dead rows write there, several
    to one slot, and nothing reads it).  Then drain as the engine does."""
    from repro_torch.serve import make_fused_decode

    plan = eng._window_plan()
    dev, cache = _clone(eng._dev), _clone(eng.cache)
    toks = eng._run_window(plan)
    t = lambda a: torch.from_numpy(a).to(eng.device)   # noqa: E731
    want, last, counters, new = make_fused_decode(cfg, n_ticks=plan.n)(
        params, dev["last_token"], cache, dev["offsets"], eng.tick,
        dev["temps"], dev["topks"], dev["seeds"], dev["counters"],
        t(plan.alive), t(plan.budgets), t(plan.stops))
    assert np.array_equal(toks, want.cpu().numpy())
    assert torch.equal(last, eng._dev["last_token"])
    assert torch.equal(counters, eng._dev["counters"])
    assert torch.equal(new["pos"], eng.cache["pos"])
    trash = slice(None, -1) if "block_tables" in cache else slice(None)
    for got_e, want_e in zip(eng.cache["layers"], new["layers"]):
        for name in got_e:
            assert torch.equal(got_e[name][:, trash],
                               want_e[name][:, trash]), name
    for name, got_t in eng.cache.get("cross", {}).items():
        # the encoder-decoder's static cross-KV: read, never written
        assert torch.equal(got_t, new["cross"][name]), name
        assert torch.equal(got_t, cache["cross"][name]), name
    eng.stats["decode_calls"] += 1
    eng.tick += plan.n
    eng._drain(plan, toks)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_graph_window_equals_eager_window(cuda, layout, kv_quant):
    """A window replayed from its CUDA graph leaves the bytes the eager
    window leaves on the same state: the (n, B) tokens, the counters, the
    next tokens, ``pos`` and every cache tensor.  Checked on the first
    window and again after admissions rebound ``pos`` and the block table
    (the static buffers take the new values).  The launches are the
    graph's (one per layer and tick) times its replays."""
    n = 4
    cfg, params, eng = _window_engine(cuda, layout, kv_quant, n)
    eng._admit_and_prefill()
    _graph_against_eager(eng, cfg, params)
    while all(s is not None for s in eng.slots):
        eng._decode_tick()
    eng._admit_and_prefill()              # rebinds pos (and the tables)
    assert eng.cache["pos"] is not eng._graphs.pos
    if layout == "paged":
        assert eng.cache["block_tables"] is not eng._graphs.block_tables
    _graph_against_eager(eng, cfg, params)
    done = eng.run(200)
    assert len(done) == 7
    graphs = eng._graphs
    kernel = ("paged_decode_attention" if layout == "paged"
              else "decode_attention")
    per = {key: w["launches"][kernel] for key, w in graphs.windows().items()}
    assert all(k == cfg.n_layers * n for k in per.values()), per
    assert graphs.launches()[kernel] == cfg.n_layers * n * graphs.replays
    assert graphs.replays == eng.stats["decode_calls"]


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_graph_windows_equal_single_ticks_on_the_card(cuda, layout):
    """Replayed windows of 4 and 8 ticks give the W = 1 streams (replays
    too), greedy and sampled, int8 KV."""
    streams = {}
    for n in (1, 4, 8):
        _, _, eng = _window_engine(cuda, layout, True, n)
        done = sorted(eng.run(300), key=lambda r: r.rid)
        streams[n] = [(r.out, r.finish_reason) for r in done]
        assert eng._graphs.replays == eng.stats["decode_calls"]
    assert streams[4] == streams[1] and streams[8] == streams[1]


def test_graph_capture_failure_raises(cuda):
    """A window that cannot be captured (here one that reads a value back
    to the host) raises from the engine's step: nothing catches it and
    carries on eagerly."""
    cfg, params, eng = _window_engine(cuda, "ring", False, 2)
    build = eng._graphs._fused_for

    def unsafe(n):
        fused = build(n)

        def window(*args):
            out = fused(*args)
            out[0].sum().item()
            return out
        return window

    eng._graphs._fused_for = unsafe
    with pytest.raises(RuntimeError):
        eng.step()
    assert eng._graphs.replays == 0 and not eng._graphs.windows()


def test_policy_and_spec_engines_run_eager_windows(cuda):
    """The choice is fixed at construction: a CUDA engine without a policy
    replays graphs; under a policy, or speculating, it has no graph
    runner; on the CPU none."""
    from repro_torch.numerics.policy import QuantPolicy
    from repro_torch.serve import Engine

    cfg = _hd64_config()
    params = registry.init_model(cfg, seed=0, device=cuda)
    assert Engine(params, cfg, 2, 64, device=cuda)._graphs is not None
    assert Engine(params, cfg, 2, 64, device=cuda, policy=QuantPolicy(
        scheme="dither", backend="auto"))._graphs is None
    assert Engine(params, cfg, 2, 64, device=cuda,
                  spec_decode=True)._graphs is None


def _snapshot_roundtrip(eng):
    import json

    return json.loads(json.dumps(eng.snapshot()))


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_in_place_restore_keeps_the_graphs_and_the_streams(cuda, layout,
                                                           kv_quant):
    """An in-place restore on a graph-replaying engine refills the cache's
    own tensors, so its captured windows stay valid and are replayed as
    they are (no window recaptured), the rebuilt cache equals the
    uninterrupted one at every written position, byte for byte, and the
    streams equal an uninterrupted engine's."""
    n = 4
    _, _, ref = _window_engine(cuda, layout, kv_quant, n)
    want = sorted((r.rid, r.out, r.finish_reason) for r in ref.run(300))
    _, _, eng = _window_engine(cuda, layout, kv_quant, n)
    for _ in range(3):
        eng.step()
    keys = set(eng._graphs.windows())
    layers = [t for e in eng.cache["layers"] for t in e.values()]
    before = eng.written_kv()
    assert before
    eng.restore(_snapshot_roundtrip(eng))
    eng.compare_written_kv(before, eng.written_kv())
    assert [t for e in eng.cache["layers"] for t in e.values()] == layers
    replays = eng._graphs.replays
    eng.run(300)
    assert eng._graphs.replays > replays
    assert keys <= set(eng._graphs.windows())
    got = sorted((r.rid, r.out, r.finish_reason) for r in eng.finished)
    assert got == want


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_restore_replay_equals_graph_written_kv(cuda, layout, kv_quant):
    """Replay ≡ graph: a fresh engine restored from a snapshot rebuilds,
    by re-prefill in admission's groups and teacher-forced replay through
    a one-tick window's graph, the bytes the serving engine's replayed
    windows wrote, at every step of the run."""
    from repro_torch.serve import Engine

    cfg, params, eng = _window_engine(cuda, layout, kv_quant, 1)
    kw = (dict(kv_layout="paged", block_size=16, num_blocks=40)
          if layout == "paged" else {})
    checked = 0
    while eng.step() or len(eng.scheduler):
        fresh = Engine(params, cfg, 4, 128, kv_quant=kv_quant, device=cuda,
                       decode_ticks=1, **kw)
        fresh.restore(_snapshot_roundtrip(eng))
        eng.compare_written_kv(eng.written_kv(), fresh.written_kv())
        checked += 1
        del fresh
    assert checked > 5


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefix_hit_restore_rebuilds_the_prefix_at_its_writers_bucket(
        cuda, kv_quant):
    """A request hits a 32-token shared prefix whose writer has finished,
    and the two prompts fall in different length buckets (40 tokens: 64;
    112: 128), where on the card a prefill at the holder's shape need not
    give the writer's bits.  The restore rebuilds the prefix by the
    writer's own admission: the holder's cache equals the uninterrupted
    one byte for byte, and so does its stream."""
    from repro_torch.serve import Engine, Request, SamplingParams

    cfg = _hd64_config()
    params = registry.init_model(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(1)
    system = rng.integers(1, cfg.vocab_size, size=32).tolist()
    prompts = [system + rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in (8, 80)]

    def run():
        eng = Engine(params, cfg, 4, 128, kv_quant=kv_quant, device=cuda,
                     kv_layout="paged", block_size=16, num_blocks=40)
        eng.submit(Request(rid=0, prompt=prompts[0],
                           sampling=SamplingParams(max_new=3)))
        eng.run(50)
        eng.submit(Request(rid=1, prompt=prompts[1], sampling=SamplingParams(
            temperature=0.8, top_k=20, seed=1, max_new=12)))
        return eng

    ref = run()
    ref.run(100)
    eng = run()
    for _ in range(4):
        eng.step()
    assert eng.stats["prefix_hit_tokens"] == 32
    before = eng.written_kv()
    assert list(before) == [1]
    eng.restore(_snapshot_roundtrip(eng))
    assert eng.last_restore["ghosts"] == 1
    assert eng.last_restore["levels"] == 2
    eng.compare_written_kv(before, eng.written_kv())
    eng.run(100)
    got = sorted((r.rid, r.out, r.finish_reason) for r in eng.finished)
    assert got == sorted((r.rid, r.out, r.finish_reason)
                         for r in ref.finished)


def test_restart_loop_frees_the_crashed_engine_before_it_captures(cuda,
                                                                   tmp_path):
    """``run_serve_with_restarts`` drops a crashed engine (its cache, its
    graphs) before the fresh one captures its first window: a graph freed
    during a capture would invalidate it."""
    import gc
    import weakref

    from repro_torch.dist.fault_tolerance import (FailureInjector,
                                                  run_serve_with_restarts)
    from repro_torch.serve import Engine, Request, SamplingParams
    from repro_torch.serve import graphs as graphs_mod

    cfg = _hd64_config()
    params = registry.init_model(cfg, seed=0, device=cuda)
    snap = str(tmp_path / "snap.json")
    injector = FailureInjector(crash_at={3: "mid_window"})
    engines, alive_at_capture = [], []
    capture = graphs_mod.WindowGraphs._capture

    def watched(self, *args):
        gc_was_on = gc.isenabled()
        gc.disable()                    # only the restart loop may collect
        alive_at_capture.append([r() is not None for r in engines[:-1]])
        if gc_was_on:
            gc.enable()
        return capture(self, *args)

    def make_engine():
        eng = Engine(params, cfg, 4, 128, device=cuda, injector=injector,
                     snapshot_path=snap)
        eng.cycle = eng                 # a reference cycle, as in practice
        engines.append(weakref.ref(eng))
        return eng

    def submit(eng):
        for r in range(4):
            eng.submit(Request(rid=r, prompt=list(range(1, 9 + r)),
                               sampling=SamplingParams(max_new=8)))

    graphs_mod.WindowGraphs._capture = watched
    try:
        eng = run_serve_with_restarts(make_engine, submit,
                                      snapshot_path=snap, ticks=200)
    finally:
        graphs_mod.WindowGraphs._capture = capture
    assert len(engines) == 2 and eng.metrics.counters["recoveries"] == 1
    assert alive_at_capture and not any(any(a) for a in alive_at_capture)


@pytest.mark.parametrize("batch,seq", [(2, 16), (4, 64)])
def test_train_step_through_kernel6_equals_plain(cuda, batch, seq):
    """Two training steps under the dither policy through kernel 6's policy
    entry (32 rows: the decode regime; 256: prefill) against the same
    steps through its plain version (``torch-ref``): every new param,
    moment, counter and the loss bit for bit; launches 7 × layers + 1 in
    the forward plus 7 × layers recomputed, and none on the plain route.
    After ``apply_updates`` every updated weight's cached absmax is the
    absmax of its new values, so the second step reads fresh ranges."""
    from repro_torch import tree
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.kernels import dither_matmul as dm
    from repro_torch.models import transformer
    from repro_torch.numerics.policy import QuantPolicy
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import trainer

    cfg = get_config("smollm_135m").reduced()
    start = trainer.init_train_state(cfg, seed=0, device=cuda)
    dcfg = DataConfig(batch, seq, seed=1)
    out = {}
    for backend in ("cuda", "torch-ref"):
        step = trainer.make_train_step(
            cfg, AdamW(lr=1e-2), policy=QuantPolicy(scheme="dither",
                                                    backend=backend))
        state, losses, launches = start, [], []
        for s in range(2):
            dm.dither_matmul_scaled.launches = 0
            state, m = step(state, synthetic_batch(cfg, dcfg, s,
                                                   device=cuda))
            torch.cuda.synchronize()
            losses.append(m["loss"])
            launches.append(dm.dither_matmul_scaled.launches)
        out[backend] = (state, losses, launches)
    assert out["cuda"][2] == [14 * cfg.n_layers + 1] * 2
    assert out["torch-ref"][2] == [0, 0]
    assert all(torch.equal(a, b) for a, b in zip(out["cuda"][1],
                                                 out["torch-ref"][1]))
    for a, b in zip(tree.leaves(out["cuda"][0]),
                    tree.leaves(out["torch-ref"][0])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    params = out["cuda"][0]["params"]
    weights = [params["embed"].T]
    for bp, _, _, _ in transformer._layers(params, cfg):
        weights += [bp["attn"][k] for k in ("wq", "wk", "wv", "wo")]
        weights += [bp["mlp"][k] for k in ("wg", "wu", "wd")]
    for w in weights:
        assert torch.equal(dm.weight_absmax(w), ref.policy_absmax(w))


# ------------------------------------------------ the rest of the zoo


def _zoo_config(arch):
    """A zoo config at ``.reduced()`` with the kernels' head dim 64."""
    return dataclasses.replace(get_config(arch).reduced(), head_dim=64)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nkv,group,hd", [(8, 4, 128), (36, 1, 64),
                                          (2, 7, 64), (8, 2, 64),
                                          (16, 1, 128)])
def test_attention_kernels_at_zoo_shapes(cuda, quant, nkv, group, hd):
    """Kernels 1–4 at the (n_kv, group, head dim) of granite-3-8b,
    minicpm-2b, internvl2-1b, granite-moe-1b-a400m and qwen2-moe-a2.7b:
    ring and paged decode within 1e-4 of the plain version, paged equal to
    ring at 64-token blocks, every verify row (ring and paged, K 4) equal
    to the decode kernel at its position, bit for bit."""
    pos = [0, 70, 255, 600, 1000]
    t = _ring(nkv + hd, b=5, cap=1024, nkv=nkv, group=group, hd=hd,
              quant=quant, pos_vals=pos, device=cuda)
    got = da.decode_attention(*t)
    want = ref.decode_attention_ref(*t, block=(da.KERNEL_BLOCK,),
                                    split=da.SPLIT_TILES)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    q, k, v, kpos, p, ks, vs = t
    bt = torch.arange(5 * 16, dtype=torch.int32, device=cuda).reshape(5, 16)
    pool = [x.reshape((5 * 16, 64) + x.shape[2:]) if x is not None else None
            for x in (k, v, ks, vs)]
    pk = [torch.cat([x, torch.zeros_like(x[:1])]) if x is not None else None
          for x in pool]
    paged = pda.paged_decode_attention(q, pk[0], pk[1], bt, p, pk[2], pk[3])
    assert torch.equal(paged, got)
    for kernel, decode, table in (
            (va.verify_attention, da.decode_attention, kpos),
            (pva.paged_verify_attention, pda.paged_decode_attention, None)):
        tv = _ring(nkv + hd + 1, b=5, cap=1024, nkv=nkv, group=group, hd=hd,
                   quant=quant, pos_vals=[p_ - 3 if p_ > 3 else p_
                                          for p_ in pos], device=cuda, kq=4)
        qv, kv_, vv, kposv, pv, ksv, vsv = tv
        if table is None:
            kv_, vv, ksv, vsv = (
                None if x is None else torch.cat([
                    x.reshape((5 * 16, 64) + x.shape[2:]),
                    torch.zeros_like(x.reshape((5 * 16, 64) + x.shape[2:])
                                     [:1])])
                for x in (kv_, vv, ksv, vsv))
            kposv = bt
        out = kernel(qv, kv_, vv, kposv, pv, ksv, vsv)
        for r in range(4):
            one = decode(qv[:, r].contiguous(), kv_, vv, kposv, pv + r, ksv,
                         vsv)
            assert torch.equal(out[:, r], one), (kernel, r)


@pytest.mark.parametrize("m,k,n,tied", [(8, 4096, 12800, False),
                                        (8, 12800, 4096, False),
                                        (8, 896, 151664, True),
                                        (8, 2048, 5632, False)])
def test_policy_entry_at_zoo_shapes(cuda, m, k, n, tied):
    """Kernel 6's policy entry at granite-3-8b's MLP (K 12,800: K·255² <
    2³¹), internvl2's tied padded head (the transposed embedding) and
    qwen2-moe's shared expert, bit for bit its plain version."""
    from repro_torch.kernels import dither_matmul as dm

    gen = torch.Generator().manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen).bfloat16().to(cuda)
    w = (torch.randn((n, k) if tied else (k, n), generator=gen)
         * 0.05).bfloat16().to(cuda)
    w = w.T if tied else w
    for scheme in ("deterministic", "stochastic", "dither"):
        kw = dict(bits=8, scheme=scheme, counter=5, seed=2)
        got = dm.dither_matmul_scaled(x, w, dm.weight_absmax(w), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.dither_matmul_scaled_ref(x, w, **kw))


def _zoo_engine(cuda, arch, layout, n, kv_quant=True):
    from repro_torch.serve import Engine, Request, SamplingParams

    cfg = _zoo_config(arch)
    params = registry.init_model(cfg, seed=0, device=cuda)
    kw = (dict(kv_layout="paged", block_size=64, prefix_cache=False)
          if layout == "paged" else {})
    eng = Engine(params, cfg, 4, 128, kv_quant=kv_quant, device=cuda,
                 decode_ticks=n, **kw)
    rng = np.random.default_rng(1)
    for r in range(6):
        eng.submit(Request(rid=r, prompt=rng.integers(
            1, cfg.vocab_size, size=int(rng.integers(5, 40))).tolist(),
            sampling=SamplingParams(temperature=0.8 * (r % 2), top_k=20,
                                    seed=r, max_new=4 + 2 * r,
                                    counter_offset=100 * r)))
    return cfg, params, eng


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "qwen2_moe_a2_7b"])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_moe_graph_window_equals_eager_window(cuda, arch, layout):
    """An MoE decode window (top-k, the capacity cumsum, the scatter-add
    and the gather inside) replayed from its CUDA graph leaves the eager
    window's bytes, on the first window and after an admission rebinds
    ``pos`` and the block table; every window is one replay."""
    cfg, params, eng = _zoo_engine(cuda, arch, layout, 4)
    eng._admit_and_prefill()
    _graph_against_eager(eng, cfg, params)
    while all(s is not None for s in eng.slots):
        eng._decode_tick()
    eng._admit_and_prefill()
    _graph_against_eager(eng, cfg, params)
    done = eng.run(300)
    assert len(done) == 6
    assert eng._graphs.replays == eng.stats["decode_calls"]


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "internvl2_1b"])
def test_zoo_paged_equals_ring_on_the_card(cuda, arch):
    """Paged (64-token blocks, the kernels' tile; prefix cache off) and
    ring engines give the same streams on the card, MoE included: a
    wave's prefill is one call of the same shape in both layouts, as in
    the reference."""
    streams = {}
    for layout in ("ring", "paged"):
        _, _, eng = _zoo_engine(cuda, arch, layout, 1, kv_quant=False)
        streams[layout] = [r.out for r in sorted(eng.run(300),
                                                 key=lambda r: r.rid)]
    assert streams["paged"] == streams["ring"]


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "qwen2_moe_a2_7b",
                                  "internvl2_1b"])
def test_zoo_train_step_through_kernel6_equals_plain(cuda, arch):
    """One MoE or VLM train step under the dither policy through kernel 6
    against its plain version: loss and every new leaf bit for bit;
    launches a step = the dense products (attention, and a dense MLP or
    qwen2-moe's shared expert; the routed experts are fake-quantised
    einsums) × layers, twice with remat, plus the head."""
    from repro_torch import tree
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.kernels import dither_matmul as dm
    from repro_torch.numerics.policy import QuantPolicy
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import trainer

    cfg = _zoo_config(arch)
    start = trainer.init_train_state(cfg, seed=0, device=cuda)
    batch = synthetic_batch(cfg, DataConfig(4, 64, seed=1), 0, device=cuda)
    per = 4 + (3 if not cfg.n_experts or cfg.shared_d_ff else 0)
    out = {}
    for backend in ("cuda", "torch-ref"):
        step = trainer.make_train_step(
            cfg, AdamW(lr=1e-2), policy=QuantPolicy(scheme="dither",
                                                    backend=backend))
        dm.dither_matmul_scaled.launches = 0
        state, m = step(start, batch)
        torch.cuda.synchronize()
        out[backend] = (state, m["loss"], dm.dither_matmul_scaled.launches)
    assert out["cuda"][2] == 2 * per * cfg.n_layers + 1
    assert out["torch-ref"][2] == 0
    assert torch.equal(out["cuda"][1], out["torch-ref"][1])
    for a, b in zip(tree.leaves(out["cuda"][0]),
                    tree.leaves(out["torch-ref"][0])):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------- the recurrent configs


@pytest.mark.parametrize("quant", [False, True])
def test_ring_kernel_at_head_dim_256(cuda, quant):
    """Kernel 1 at recurrentgemma's attention shape (1 KV head, group 16,
    head dim 256) against its plain version: a wrapped ring of 2,048
    slots with positions to 4,095 under the 2,048-token window, and a
    1,024-slot ring without one; f32 allclose at 1e-4 (summation order
    only).  The other attention kernels still refuse head dim 256."""
    for cap, window, pos_vals in (
            (2048, 2048, [0, 37, 255, 1023, 2047, 2048, 3000, 4095]),
            (1024, 0, [0, 37, 255, 511, 700, 1023, 1500, 2047])):
        t = _ring(cap + quant, b=8, cap=cap, nkv=1, group=16, hd=256,
                  quant=quant, pos_vals=pos_vals, device=cuda)
        got = da.decode_attention(*t, window=window)
        want = ref.decode_attention_ref(*t, window=window,
                                        block=(da.KERNEL_BLOCK,),
                                        split=da.SPLIT_TILES)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    q, k, v, kp, pos, ks, vs = t
    with pytest.raises(ValueError, match="head dim"):
        va.verify_attention(q[:, None].contiguous(), k, v, kp, pos, ks, vs)


def _recurrent_config(arch):
    """A recurrent config at ``.reduced()``; recurrentgemma with the head
    dim 64 the kernel takes (the reduced one is 32)."""
    cfg = get_config(arch).reduced()
    if cfg.n_kv_heads:
        cfg = dataclasses.replace(cfg, head_dim=64)
    return cfg


def _rows(cache, idx):
    """Rows ``idx`` of every layer tensor of a ring cache (stacked entries
    carry the row at axis 1, remainder entries at axis 0)."""
    out = []
    for axis, entries in ((1, cache["layers"]), (0, cache["remainder"])):
        for entry in entries:
            out += [entry[n].index_select(axis, idx) for n in sorted(entry)]
    return out


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", ["mamba2_370m", "recurrentgemma_9b"])
def test_scanned_prefill_graph_equals_eager(cuda, arch, kv_quant):
    """The scanned prefill replayed from its captured step, on a cache's
    own tensors, leaves the rows it prefills as the eager scanned prefill
    leaves them (logits, positions and every cache tensor, byte for byte,
    short rows frozen) and the rows without a length as they were; twice,
    so the second call's reset of its rows is checked too."""
    from repro_torch.serve.graphs import PrefillGraphs

    cfg = _recurrent_config(arch)
    params = registry.init_model(cfg, seed=0, device=cuda)
    cache = registry.make_cache(params, cfg, 4, 64, kv_quant=kv_quant,
                                device=cuda)
    graphs = PrefillGraphs(params, cfg, cache, 64, cuda)
    rng = np.random.default_rng(1)
    for s, idle in ((16, 2), (32, 1)):
        toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                             size=(4, s))).to(cuda)
        lens = torch.tensor([s, 5, s - 7, s - 3], dtype=torch.int32,
                            device=cuda)
        lens[idle] = 0
        off = torch.tensor([0, 7, 3, 100], dtype=torch.int32, device=cuda)
        idle_row = torch.tensor([idle], device=cuda)
        kept = [x.clone() for x in _rows(cache, idle_row)]
        got_logits, got = graphs(params, toks, lens, off)
        want_logits, want = registry.apply_prefill(
            params, cfg, toks, lens, 64, kv_quant=kv_quant, kv_offset=off)
        on = torch.nonzero(lens).flatten()
        assert got["layers"] is cache["layers"]
        assert torch.equal(got_logits[on], want_logits[on])
        assert torch.equal(got["pos"][on], want["pos"][on])
        for a, b in zip(_rows(got, on), _rows(want, on)):
            assert torch.equal(a, b)
        for a, b in zip(_rows(cache, idle_row), kept):
            assert torch.equal(a, b)
    assert graphs.replays == 16 + 32


@pytest.mark.parametrize("arch", ["mamba2_370m", "recurrentgemma_9b"])
def test_recurrent_engine_on_the_card(cuda, arch):
    """A recurrent engine on the card: its windows are graph replays that
    equal the eager window byte for byte (states included), W = 4 gives
    the W = 1 streams, and an in-place restore rebuilds every slot's
    written KV and state byte for byte."""
    from repro_torch.serve import Engine, Request, SamplingParams

    cfg = _recurrent_config(arch)
    params = registry.init_model(cfg, seed=0, device=cuda)

    def engine(n):
        eng = Engine(params, cfg, 4, 128, kv_quant=True, device=cuda,
                     decode_ticks=n)
        rng = np.random.default_rng(0)
        for r in range(7):
            eng.submit(Request(rid=r, prompt=rng.integers(
                1, cfg.vocab_size, size=int(rng.integers(5, 40))).tolist(),
                sampling=SamplingParams(temperature=0.8 * (r % 2), top_k=20,
                                        seed=r, max_new=5 + 3 * r,
                                        counter_offset=100 * r)))
        return eng

    streams = {}
    for n in (1, 4):
        eng = engine(n)
        eng._admit_and_prefill()
        _graph_against_eager(eng, cfg, params)
        eng.step()
        before = eng.written_kv()
        eng.restore(_snapshot_roundtrip(eng))
        Engine.compare_written_kv(before, eng.written_kv())
        done = sorted(eng.run(300), key=lambda r: r.rid)
        streams[n] = [(r.out, r.finish_reason) for r in done]
        assert eng._prefill.replays > 0
    assert streams[4] == streams[1]


# ------------------------------------------- the encoder-decoder


def _encdec_config():
    """whisper-small at ``.reduced()`` with the head dim 64 the kernel
    takes (the reduced one is 32)."""
    return dataclasses.replace(get_config("whisper_small").reduced(),
                               head_dim=64)


def _encdec_frames(cfg, b, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, cfg.n_enc_tokens, cfg.d_model),
                       generator=g).to(torch.bfloat16).to(device)


def test_encdec_scanned_prefill_graph_equals_eager(cuda):
    """The encoder-decoder's scanned prefill replayed from its captured
    step, on the engine-shaped cache's own tensors, leaves the rows it
    prefills as the eager scanned prefill (over the same cross-KV) leaves
    them, byte for byte, the rows without a length as they were, and the
    cross-KV untouched; twice."""
    from repro_torch.serve.graphs import PrefillGraphs

    cfg = _encdec_config()
    params = registry.init_model(cfg, seed=0, device=cuda)
    cache = registry.make_cache(params, cfg, 4, 64,
                                _encdec_frames(cfg, 4, cuda), device=cuda)
    cross = {k: v.clone() for k, v in cache["cross"].items()}
    graphs = PrefillGraphs(params, cfg, cache, 64, cuda)
    rng = np.random.default_rng(1)
    for s, idle in ((16, 2), (32, 1)):
        toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                             size=(4, s))).to(cuda)
        lens = torch.tensor([s, 5, s - 7, s - 3], dtype=torch.int32,
                            device=cuda)
        lens[idle] = 0
        idle_row = torch.tensor([idle], device=cuda)
        kept = [x.clone() for x in _rows(cache, idle_row)]
        got_logits, got = graphs(params, toks, lens)
        fresh = registry.make_cache(params, cfg, 4, 64, device=cuda,
                                    cross=cache["cross"])
        want_logits, want = registry.apply_prefill(params, cfg, toks, lens,
                                                   64, cache0=fresh)
        on = torch.nonzero(lens).flatten()
        assert got["cross"] is cache["cross"]
        assert torch.equal(got_logits[on], want_logits[on])
        assert torch.equal(got["pos"][on], want["pos"][on])
        for a, b in zip(_rows(got, on), _rows(want, on)):
            assert torch.equal(a, b)
        for a, b in zip(_rows(cache, idle_row), kept):
            assert torch.equal(a, b)
        for k in ("k", "v"):
            assert torch.equal(cache["cross"][k], cross[k])


def test_encdec_engine_on_the_card(cuda):
    """An encoder-decoder engine on the card (its frames row i slot i's):
    prompts prefilled by the captured scanned-prefill step, windows
    replayed that equal the eager window byte for byte (the cross-KV read
    and unchanged), W = 4 giving the W = 1 streams, ``kv_quant`` inert,
    an in-place restore rebuilding every slot's self-KV and cross-KV byte
    for byte; kernel 1 launched."""
    from repro_torch.serve import Engine, Request, SamplingParams

    cfg = _encdec_config()
    params = registry.init_model(cfg, seed=0, device=cuda)
    frames = _encdec_frames(cfg, 4, cuda)

    def engine(n, kv_quant=False):
        eng = Engine(params, cfg, 4, 128, kv_quant=kv_quant, device=cuda,
                     decode_ticks=n, frames=frames)
        rng = np.random.default_rng(0)
        for r in range(7):
            eng.submit(Request(rid=r, prompt=rng.integers(
                1, cfg.vocab_size, size=int(rng.integers(5, 40))).tolist(),
                sampling=SamplingParams(temperature=0.8 * (r % 2), top_k=20,
                                        seed=r, max_new=5 + 3 * r,
                                        counter_offset=100 * r)))
        return eng

    streams = {}
    for n, kv_quant in ((1, False), (4, False), (1, True)):
        eng = engine(n, kv_quant)
        da.decode_attention.launches = 0
        eng._admit_and_prefill()
        _graph_against_eager(eng, cfg, params)
        eng.step()
        before = eng.written_kv()
        eng.restore(_snapshot_roundtrip(eng))
        Engine.compare_written_kv(before, eng.written_kv())
        done = sorted(eng.run(300), key=lambda r: r.rid)
        streams[n, kv_quant] = [(r.out, r.finish_reason) for r in done]
        assert eng._prefill.replays > 0 and eng._graphs.replays > 0
        assert da.decode_attention.launches > 0
    assert streams[4, False] == streams[1, False] == streams[1, True]


def test_encdec_train_step_through_kernel6_equals_plain(cuda):
    """One encoder-decoder train step under the dither policy through
    kernel 6 against its plain version: loss and every new leaf bit for
    bit; launches a step = 6 products an encoder layer (once: the encoder
    is not recomputed) + 10 a decoder layer (self and cross attention,
    MLP; twice with remat), the tied head plain."""
    from repro_torch import tree
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.kernels import dither_matmul as dm
    from repro_torch.numerics.policy import QuantPolicy
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import trainer

    cfg = _encdec_config()
    start = trainer.init_train_state(cfg, seed=0, device=cuda)
    batch = synthetic_batch(cfg, DataConfig(4, 64, seed=1), 0, device=cuda)
    out = {}
    for backend in ("cuda", "torch-ref"):
        step = trainer.make_train_step(
            cfg, AdamW(lr=1e-2), policy=QuantPolicy(scheme="dither",
                                                    backend=backend))
        dm.dither_matmul_scaled.launches = 0
        state, m = step(start, batch)
        torch.cuda.synchronize()
        out[backend] = (state, m["loss"], dm.dither_matmul_scaled.launches)
    assert out["cuda"][2] == 6 * cfg.n_enc_layers + 2 * 10 * cfg.n_layers
    assert out["torch-ref"][2] == 0
    assert torch.equal(out["cuda"][1], out["torch-ref"][1])
    for a, b in zip(tree.leaves(out["cuda"][0]),
                    tree.leaves(out["torch-ref"][0])):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_mesh_ranks_sharing_the_card(cuda, tmp_path, shape):
    """Sharded serving with every rank on the one card (gloo; NCCL refuses
    two ranks on one GPU), SmolLM-135M reduced at head dim 64: every
    rank's host streams are equal, KV heads shard on a 2-way 'model' axis,
    and the streams are the single-device engine's bit for bit where the
    shard-purity probe finds every library op summing in the same order
    at the shard's shapes (the card's libraries may pick another order at
    N/tp columns or B/dp rows)."""
    import _torch_mesh

    names = ["purity", "stream-ring-int8", "stream-paged-bf16"]
    ranks = _torch_mesh.run_mesh(shape, names, str(tmp_path), device="cuda")
    for rank, res in enumerate(ranks):
        assert "error" not in res, res["error"]
        for name in names:
            assert "error" not in res[name], (rank, res[name]["error"])
    pure = not any(n for part in ranks[0]["purity"].values()
                   for n in part.values())
    for name in names[1:]:
        outs = [r[name] for r in ranks]
        assert all(o["got"] == outs[0]["got"] for o in outs), name
        assert outs[0]["heads_sharded"] is (shape[1] > 1)
        assert outs[0]["window_mode"] == ("eager" if shape[1] > 1
                                          else "graph")
        if pure:
            assert outs[0]["got"] == outs[0]["want"], name


@pytest.mark.parametrize("m,k,n,trans", [(256, 576, 384, False),
                                         (300, 200, 260, True),
                                         (2048, 1536, 1792, False)])
def test_kernel6_sharded_entry_equals_plain(cuda, m, k, n, trans):
    """Kernel 6's sharded entry on row, column and K blocks (partials, an
    exact sum, the epilogue kernel) and a token shard, each bit for bit its
    plain version, and together the unsharded policy product; each launch
    counted under its block kind."""
    from repro_torch.kernels import dither_matmul as dm

    counts = (dict(dm.dither_matmul_sharded.by_block),
              dm.dither_matmul_epilogue.launches)

    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    x = (torch.randn((m, k), generator=gen, device="cuda") * 2).bfloat16()
    w = torch.randn((n, k) if trans else (k, n), generator=gen,
                    device="cuda").bfloat16()
    wv = w.T if trans else w
    ax, aw = ref.policy_absmax(x), ref.policy_absmax(w)
    kw = dict(bits=8, scheme="dither", counter=5, seed=9)
    full = dm.dither_matmul_scaled(x, wv, aw, **kw)

    def both(xb, wb, block, partials=False):
        got = dm.dither_matmul_sharded(xb, wb, ax, aw, block=block,
                                       partials=partials, **kw)
        plain = ref.dither_matmul_scaled_ref(xb, wb, aw, x_absmax=ax,
                                             block=block, partials=partials,
                                             **kw)
        for g, p in zip(got if partials else (got,),
                        plain if partials else (plain,)):
            assert torch.equal(g, p)
        return got

    h, c, kk = m // 2, n // 2, k // 2
    rows = [both(x[i * h:(i + 1) * h].contiguous(), wv,
                 ref.MatmulBlock(m, k, n, m0=i * h)) for i in range(2)]
    assert torch.equal(torch.cat(rows), full)
    cols = [both(x, w[i * c:(i + 1) * c].T if trans
                 else w[:, i * c:(i + 1) * c].contiguous(),
                 ref.MatmulBlock(m, k, n, n0=i * c)) for i in range(2)]
    assert torch.equal(torch.cat(cols, 1), full)
    parts = [both(x[:, i * kk:(i + 1) * kk].contiguous(),
                  w[:, i * kk:(i + 1) * kk].contiguous().T if trans
                  else w[i * kk:(i + 1) * kk].contiguous(),
                  ref.MatmulBlock(m, k, n, k0=i * kk), partials=True)
             for i in range(2)]
    acc, rowsum, colsum = (parts[0][i] + parts[1][i] for i in range(3))
    got = dm.dither_matmul_epilogue(acc, rowsum, colsum, ax, aw, bits=8, k=k)
    assert torch.equal(got, full)
    assert torch.equal(got, ref.dither_matmul_scaled_epilogue_ref(
        acc, rowsum, colsum, ax, aw, bits=8, k=k))
    s = m // 4
    xs = x.reshape(4, s, k)[:, s // 2:].reshape(-1, k).contiguous()
    seg = both(xs, wv, ref.MatmulBlock(m, k, n, m0=s // 2, seg=s - s // 2,
                                       seg_stride=s))
    assert torch.equal(seg, full.reshape(4, s, n)[:, s // 2:].reshape(-1, n))
    assert {b: c - counts[0][b] for b, c in
            dm.dither_matmul_sharded.by_block.items()} == {
        "rows": 3, "columns": 2, "k_block": 2}
    assert dm.dither_matmul_epilogue.launches - counts[1] == 1


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_train_mesh_step_through_kernel6_equals_plain(cuda, tmp_path, shape):
    """A training-mesh step with every rank on the one card (gloo): through
    kernel 6's sharded entry and through its plain version, bit for bit on
    every rank, with the sharded entry launched."""
    import _torch_mesh
    import _torch_train_mesh  # noqa: F401  (registers the cases)

    ranks = _torch_mesh.run_mesh(shape, ["train-kernel6-parity"],
                                 str(tmp_path), device="cuda",
                                 modules=("_torch_train_mesh",))
    for res in ranks:
        r = res["train-kernel6-parity"]
        assert "error" not in r, r["error"]
        assert r["equal"] and r["launches"] > 0


# ---------------------------------------------------------------------------
# the kernel autotuner's candidates and a tuned engine (kernels/autotune.py)
# ---------------------------------------------------------------------------


def _ring_as_pool(t, bs, seed):
    """A ring snapshot (no wrap) as a pool of ``bs``-token blocks in
    shuffled order: (q, k, v, block_tables, pos, k_scale, v_scale)."""
    q, k, v, _, pos, ks, vs = t
    b, cap = k.shape[:2]
    nb = cap // bs
    perm = torch.randperm(b * nb, generator=torch.Generator().manual_seed(
        seed)).to(k.device)

    def to_pool(x):
        if x is None:
            return None
        tail = tuple(x.shape[2:])
        pool = torch.zeros((b * nb + 1, bs) + tail, dtype=x.dtype,
                           device=x.device)
        pool[perm] = x.reshape((b * nb, bs) + tail)
        return pool

    return [q, to_pool(k), to_pool(v), perm.reshape(b, nb).to(torch.int32),
            pos, to_pool(ks), to_pool(vs)]


@pytest.mark.parametrize("quant", [False, True])
def test_autotune_attention_candidates_match_plain(cuda, quant):
    """Kernels 1-4 at every tile the autotuner may pick (SmolLM-135M's
    heads, a 512-slot ring): each against its plain version at that tile
    and the kernels' split within 1e-4; at pool blocks of the same size
    the paged kernels equal the ring kernels bit for bit; every verify row
    equals the decode kernel at its position and tile bit for bit; the
    dispatcher with that block launches the same kernel."""
    from repro_torch.kernels import autotune, dispatch

    b, cap, nkv, group, hd, kq = 4, 512, 3, 3, 64, 4
    pos_vals = [0, 130, 300, 511 - kq]
    t = _ring(21, b=b, cap=cap, nkv=nkv, group=group, hd=hd, quant=quant,
              pos_vals=pos_vals, device=cuda)
    tv = _ring(22, b=b, cap=cap, nkv=nkv, group=group, hd=hd, quant=quant,
               pos_vals=pos_vals, kq=kq, device=cuda)
    cands = autotune.decode_attention_candidates(cap, hd=hd, group=group,
                                                 quantized=quant)
    assert cands == [(8,), (16,), (32,), (64,)]
    for (bk,) in cands:
        kw = dict(block=(bk,), split=da.SPLIT_TILES)
        got = da.decode_attention(*t, block=(bk,))
        gv = va.verify_attention(*tv, block=(bk,))
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref.decode_attention_ref(*t, **kw),
                                   atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(gv, ref.verify_attention_ref(*tv, **kw),
                                   atol=1e-4, rtol=1e-4)
        _rows_equal_decode(
            gv, lambda *a, **k: da.decode_attention(*a, block=(bk,), **k),
            tv, 0)
        q, k, v, kp, pos, ks, vs = t
        assert torch.equal(dispatch.decode_attention(
            q, k, v, kp, pos, k_scale=ks, v_scale=vs, block=(bk,)), got)
        paged = pda.paged_decode_attention(*_ring_as_pool(t, bk, bk))
        pagedv = pva.paged_verify_attention(*_ring_as_pool(tv, bk, bk + 1))
        torch.cuda.synchronize()
        assert torch.equal(paged, got), bk
        assert torch.equal(pagedv, gv), bk
    with pytest.raises(ValueError, match="not a candidate"):
        da.decode_attention(*t, block=(24,))
    with pytest.raises(ValueError, match="not a candidate"):
        va.verify_attention(*tv, block=(128,))


def test_autotune_dither_candidates_are_bitwise(cuda):
    """Kernels 5 and 6 give the same bits at every candidate: kernel 6's
    policy entry and f32 entry at the serve path's decode products (the
    LM head as the transposed view) at every ``(mt, cps, splits)`` against
    the plain version; kernel 5 at its one candidate through the
    dispatcher; a non-candidate raises before any launch."""
    from repro_torch.kernels import autotune, dispatch
    from repro_torch.kernels import dither_matmul as dm
    from repro_torch.kernels import quantize as qk

    gen = torch.Generator().manual_seed(8)
    kw = dict(bits=8, scheme="dither", counter=77, seed=3)
    for m, k, n in ((8, 576, 576), (8, 576, 192), (8, 1536, 576),
                    (8, 576, 49152)):
        x = torch.randn((m, k), generator=gen).to(torch.bfloat16).to(cuda)
        if n == 49152:
            w = (torch.randn((n, k), generator=gen) * 0.05).to(
                torch.bfloat16).to(cuda).T
        else:
            w = (torch.randn((k, n), generator=gen) * 0.05).to(
                torch.bfloat16).to(cuda)
        aw = dm.weight_absmax(w)
        want = ref.dither_matmul_scaled_ref(x, w, **kw)
        a = (torch.rand((m, k), generator=gen) * 2 - 1).to(cuda)
        b = (torch.rand((k, n), generator=gen) * 2 - 1).to(cuda)
        fk = dict(a_range=(-1.0, 1.0), b_range=(-1.0, 1.0), **kw)
        want_f = ref.dither_matmul_ref(a, b, **fk)
        cands = autotune.matmul_candidates(m, k, n)
        assert len(cands) >= 10
        for blk in cands:
            got = dm.dither_matmul_scaled(x, w, aw, block=blk, **kw)
            got_f = dispatch.matmul(a, b, block=blk, **fk)
            torch.cuda.synchronize()
            assert torch.equal(got, want), ((m, k, n), blk)
            assert torch.equal(got_f, want_f), ((m, k, n), blk)
        with pytest.raises(ValueError, match="not a candidate"):
            dm.dither_matmul_scaled(x, w, aw, block=(2, 1, 18), **kw)
    x = (torch.rand((576, 1536), generator=gen) * 2 - 1).to(cuda)
    qkw = dict(bits=8, lo=-1.0, hi=1.0, scheme="dither", counter=5, seed=2)
    before = qk.quantize.launches
    got = dispatch.quantize(x, block=(), **qkw)
    assert qk.quantize.launches == before + 1
    assert torch.equal(got, dispatch.quantize(x.cpu(), **qkw).to(cuda))
    with pytest.raises(ValueError, match="not a candidate"):
        dispatch.quantize(x, block=(8, 128), **qkw)
    assert qk.quantize.launches == before + 1


def test_tuned_engine_streams_equal_where_they_must(cuda, tmp_path,
                                                    monkeypatch):
    """Engines built under a winner cache (a 16-slot ring tile, kernel 6's
    one-chunk-per-block plans): the ring engine holds the cached tile and
    its tracer saw the cache hit; its W = 4 streams equal its W = 1 ones,
    the speculative engine's equal the plain ones (verify takes decode's
    tile), and under the dither policy the tuned streams equal the
    untuned ones bit for bit (kernel 6 is exact at every candidate)."""
    from repro_torch.kernels import autotune
    from repro_torch.numerics.policy import QuantPolicy
    from repro_torch.serve import Engine, Request, SamplingParams, Tracer

    cfg = _hd64_config()
    params = registry.init_model(cfg, seed=0, device=cuda)
    nkv, group = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    ring_key = autotune.cache_key("decode_attention", (2, 64, nkv, group, 64),
                                  "int8", 8, "flash", "cuda")
    winners = {ring_key: [16]}
    for k, n in ((cfg.d_model, cfg.n_heads * 64), (cfg.d_model, nkv * 64),
                 (cfg.n_heads * 64, cfg.d_model), (cfg.d_model, cfg.d_ff),
                 (cfg.d_ff, cfg.d_model), (cfg.d_model, cfg.vocab_padded())):
        chunks = -(-k // 32)
        winners[autotune.cache_key("matmul", (2, k, n), "bfloat16", 8,
                                   "dither", "cuda")] = [1, 1, chunks]
    cache_file = tmp_path / "autotune.json"
    cache_file.write_text(json.dumps(winners))

    def serve(**kw):
        eng = Engine(params, cfg, 2, 64, kv_quant=True, device=cuda, **kw)
        for r in range(3):
            eng.submit(Request(rid=r, prompt=[1 + r, 2, 3, 4, 5] * (r + 1),
                               sampling=SamplingParams(
                                   temperature=0.8 * (r % 2), top_k=20,
                                   seed=r, max_new=9,
                                   counter_offset=100 * r)))
        done = sorted(eng.run(200), key=lambda r: r.rid)
        return eng, [r.out for r in done]

    policy = QuantPolicy(scheme="dither", backend="auto")
    untuned = serve(policy=policy)[1]
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(cache_file))
    autotune.clear_cache()
    try:
        tr = Tracer(sink=None)
        eng, w1 = serve(trace=tr)
        assert eng.attn_block == (16,)
        assert any(r.get("name") == "autotune_cache_hit"
                   and r.get("key") == ring_key for r in tr.records())
        assert serve(decode_ticks=4)[1] == w1
        assert serve(spec_decode=True, draft_k=4)[1] == w1
        tr = Tracer(sink=None)
        assert serve(policy=policy, trace=tr)[1] == untuned
        hits = {r["key"] for r in tr.records()
                if r.get("name") == "autotune_cache_hit"}
        assert len(hits & set(winners)) >= 4, hits
    finally:
        autotune.clear_cache()
