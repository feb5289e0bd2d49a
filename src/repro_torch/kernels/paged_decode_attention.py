"""Wrapper of the hand-written CUDA paged flash-decode kernel
(``csrc/paged_decode_attention.cu``), which replaces the TPU kernel
``paged_decode_attention_call`` of the reference's
``kernels/decode_attention.py``.

``paged_decode_attention`` takes CUDA tensors to the kernel and CPU
tensors to the plain version ``ref.paged_decode_attention_ref``; any other
device raises.  For CUDA tensors it checks device, dtype, shape, contiguity
and alignment, raises on anything the kernel does not take (the limits are
in the messages), allocates the output (and the f32 scratch of the split
partials, when a row can span several splits) with ``torch.empty``,
launches on the current stream without synchronising, and adds one to
``paged_decode_attention.launches``.  Block-table entries must be ids of
the pool (idle rows point at its trailing trash block); the kernel reads
them unchecked.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import SPLIT_TILES, launch_on
from repro_torch.kernels.ref import paged_decode_attention_ref

__all__ = ["paged_decode_attention", "check_paged", "MAX_BLOCK_SIZE",
           "SOURCE"]

MAX_BLOCK_SIZE = 64   # csrc: kMaxBk — the tile is the pool block, never cut
SOURCE = "src/repro_torch/kernels/csrc/paged_decode_attention.cu"
_MAX_GROUP = 16       # csrc: kMaxGroup, one warp per query row

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_decode_attention")
    # pointers (.., out, part), then B, bs, nbmax, nkv, group, hd, window,
    # splits, 1/sqrt(hd), stream
    dims = [_I] * 8 + [_F, _P]
    lib.repro_paged_decode_attention_bf16.argtypes = [_P] * 7 + dims
    lib.repro_paged_decode_attention_int8.argtypes = [_P] * 9 + dims
    lib.repro_paged_decode_attention_bf16.restype = _I
    lib.repro_paged_decode_attention_int8.restype = _I
    return lib


def check_paged(q, k, v, block_tables, pos, k_scale, v_scale, window):
    """Raise ValueError on any input the paged kernels do not take: q is
    (B, n_kv, group, hd) for decode or (B, kq, n_kv, group, hd) for
    verify."""
    if k.dim() != 4 or q.dim() not in (4, 5) or block_tables.dim() != 2:
        raise ValueError(f"q must be (B, n_kv, group, hd), k and v "
                         f"(n_blocks, bs, n_kv, hd), block_tables (B, nbmax); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(block_tables.shape)}")
    nblk, bs, nkv, hd = k.shape
    b, group = q.shape[0], q.shape[-2]
    quantized = k.dtype == torch.int8
    if k.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"pool dtype {k.dtype} not int8 or bf16")
    want = {
        "q": (q, (b,) + tuple(q.shape[1:-3]) + (nkv, group, hd),
              torch.bfloat16),
        "k": (k, (nblk, bs, nkv, hd), k.dtype),
        "v": (v, (nblk, bs, nkv, hd), k.dtype),
        "block_tables": (block_tables, (b, block_tables.shape[1]),
                         torch.int32),
        "pos": (pos, (b,), torch.int32),
    }
    if quantized:
        if k_scale is None or v_scale is None:
            raise ValueError("an int8 pool needs k_scale and v_scale")
        want["k_scale"] = (k_scale, (nblk, bs, nkv), torch.float32)
        want["v_scale"] = (v_scale, (nblk, bs, nkv), torch.float32)
    elif k_scale is not None or v_scale is not None:
        raise ValueError("scales are for the int8 pool only")
    for name, (t, shape, dtype) in want.items():
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= bs <= MAX_BLOCK_SIZE:
        raise ValueError(f"pool block size {bs} not in [1, {MAX_BLOCK_SIZE}]: "
                         "the kernel's tile is the pool block")
    if block_tables.shape[1] < 1:
        raise ValueError("block_tables needs at least one logical block")
    if hd not in (64, 128):
        raise ValueError(f"head dim {hd} not in (64, 128)")
    if not 1 <= group <= _MAX_GROUP:
        raise ValueError(f"GQA group {group} not in [1, {_MAX_GROUP}]")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must be 16-byte aligned")
    if int(window) < 0:
        raise ValueError(f"window {window} < 0")


def paged_decode_attention(
    q: torch.Tensor,        # (B, n_kv, group, hd) bf16 — post-RoPE queries
    k: torch.Tensor,        # (n_blocks, bs, n_kv, hd) int8 codes or bf16
    v: torch.Tensor,        # (n_blocks, bs, n_kv, hd)
    block_tables: torch.Tensor,   # (B, nbmax) int32 physical block ids
    pos: torch.Tensor,      # (B,) int32
    k_scale: Optional[torch.Tensor] = None,   # (n_blocks, bs, n_kv) f32
    v_scale: Optional[torch.Tensor] = None,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Flash-decode attention over the paged block pool →
    (B, n_kv, group, hd) f32: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k, v, block_tables, pos, k_scale,
                                          v_scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda (or cpu), not "
                         f"{q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, n_kv, group, hd); got "
                         f"{tuple(q.shape)}")
    check_paged(q, k, v, block_tables, pos, k_scale, v_scale, window)
    _, bs, nkv, hd = k.shape
    b, group = q.shape[0], q.shape[2]
    lib = _lib()
    nbmax = block_tables.shape[1]
    splits = -(-nbmax // SPLIT_TILES)
    out = torch.empty((b, nkv, group, hd), dtype=torch.float32,
                      device=q.device)
    scratch = (torch.empty((b, nkv, group, splits, hd + 2),
                           dtype=torch.float32, device=q.device)
               if splits > 1 else None)
    part = None if scratch is None else scratch.data_ptr()
    dims = (b, bs, nbmax, nkv, group, hd, int(window), splits,
            float(1.0 / math.sqrt(hd)))
    if k.dtype == torch.int8:
        rc = launch_on(q.device, lib.repro_paged_decode_attention_int8,
                       q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       k_scale.data_ptr(), v_scale.data_ptr(),
                       block_tables.data_ptr(), pos.data_ptr(),
                       out.data_ptr(), part, *dims)
    else:
        rc = launch_on(q.device, lib.repro_paged_decode_attention_bf16,
                       q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       block_tables.data_ptr(), pos.data_ptr(),
                       out.data_ptr(), part, *dims)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {rc} for shapes q={tuple(q.shape)} "
                           f"k={tuple(k.shape)} {k.dtype} "
                           f"block_tables={tuple(block_tables.shape)}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
