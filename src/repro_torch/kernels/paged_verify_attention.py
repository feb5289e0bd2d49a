"""Wrapper of the hand-written CUDA paged verify-attention kernel
(``csrc/paged_verify_attention.cu``), which replaces the TPU kernel
``paged_verify_attention_call`` of the reference's
``kernels/decode_attention.py``.

``paged_verify_attention`` takes CUDA tensors to the kernel and CPU tensors
to the plain version ``ref.paged_verify_attention_ref``; any other device
raises.  For CUDA tensors it checks device, dtype, shape, contiguity and
alignment, raises on anything the kernel does not take, allocates the
output (and the f32 scratch of the split partials, when a row can span
several splits) with ``torch.empty``, launches on the current stream without
synchronising, and adds one to ``paged_verify_attention.launches``.  Row t
of the output is the paged decode kernel at ``pos + t``, bit for bit.
Block-table entries must be ids of the pool; the kernel reads them
unchecked.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import SPLIT_TILES, launch_on
from repro_torch.kernels.paged_decode_attention import check_paged
from repro_torch.kernels.ref import paged_verify_attention_ref

__all__ = ["paged_verify_attention", "SOURCE"]

SOURCE = "src/repro_torch/kernels/csrc/paged_verify_attention.cu"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_verify_attention")
    # pointers (.., out, part), then B, bs, nbmax, nkv, group, kq, hd,
    # window, splits, 1/sqrt(hd), stream
    dims = [_I] * 9 + [_F, _P]
    lib.repro_paged_verify_attention_bf16.argtypes = [_P] * 7 + dims
    lib.repro_paged_verify_attention_int8.argtypes = [_P] * 9 + dims
    lib.repro_paged_verify_attention_bf16.restype = _I
    lib.repro_paged_verify_attention_int8.restype = _I
    return lib


def paged_verify_attention(
    q: torch.Tensor,        # (B, kq, n_kv, group, hd) bf16 — post-RoPE
    k: torch.Tensor,        # (n_blocks, bs, n_kv, hd) int8 codes or bf16
    v: torch.Tensor,        # (n_blocks, bs, n_kv, hd)
    block_tables: torch.Tensor,   # (B, nbmax) int32 physical block ids
    pos: torch.Tensor,      # (B,) int32 — the first row's position
    k_scale: Optional[torch.Tensor] = None,   # (n_blocks, bs, n_kv) f32
    v_scale: Optional[torch.Tensor] = None,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Verify attention over the paged block pool →
    (B, kq, n_kv, group, hd) f32: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return paged_verify_attention_ref(q, k, v, block_tables, pos,
                                          k_scale, v_scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_verify_attention runs on cuda (or cpu), "
                         f"not {q.device}")
    if q.dim() != 5:
        raise ValueError(f"q must be (B, kq, n_kv, group, hd); got "
                         f"{tuple(q.shape)}")
    b, kq, nkv, group, hd = q.shape
    if not 1 <= kq <= 65535:
        raise ValueError(f"kq {kq} not in [1, 65535]")
    check_paged(q, k, v, block_tables, pos, k_scale, v_scale, window)
    bs = k.shape[1]
    lib = _lib()
    nbmax = block_tables.shape[1]
    splits = -(-nbmax // SPLIT_TILES)
    out = torch.empty((b, kq, nkv, group, hd), dtype=torch.float32,
                      device=q.device)
    scratch = (torch.empty((b, kq, nkv, group, splits, hd + 2),
                           dtype=torch.float32, device=q.device)
               if splits > 1 else None)
    part = None if scratch is None else scratch.data_ptr()
    dims = (b, bs, nbmax, nkv, group, kq, hd, int(window), splits,
            float(1.0 / math.sqrt(hd)))
    if k.dtype == torch.int8:
        rc = launch_on(q.device, lib.repro_paged_verify_attention_int8,
                       q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       k_scale.data_ptr(), v_scale.data_ptr(),
                       block_tables.data_ptr(), pos.data_ptr(),
                       out.data_ptr(), part, *dims)
    else:
        rc = launch_on(q.device, lib.repro_paged_verify_attention_bf16,
                       q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       block_tables.data_ptr(), pos.data_ptr(),
                       out.data_ptr(), part, *dims)
    if rc != 0:
        raise RuntimeError(f"paged_verify_attention kernel launch failed: "
                           f"CUDA error {rc} for shapes q={tuple(q.shape)} "
                           f"k={tuple(k.shape)} {k.dtype} "
                           f"block_tables={tuple(block_tables.shape)}")
    paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0
