"""Tests of the port that need an NVIDIA GPU: the CUDA kernels against
their plain versions, the wrappers' input checks, and the serving path's
launch counts.  They import torch and the port only (the card's machine
has no JAX) and skip where ``torch.cuda.is_available()`` is false:

  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ref
from repro_torch.models import registry

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ring(seed, *, b, cap, nkv, group, hd, quant, pos_vals, device):
    """A ring-cache snapshot: slot s of row i holds the latest position
    p ≡ s (mod cap) with p ≤ pos_i; unwritten slots carry k_pos = -1."""
    rng = np.random.default_rng(seed)
    kpos = np.full((b, cap), -1, np.int32)
    for i, p in enumerate(pos_vals):
        ps = np.arange(max(0, p - cap + 1), p + 1)
        kpos[i, ps % cap] = ps
    q = torch.from_numpy(rng.normal(size=(b, nkv, group, hd)).astype(
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
