"""Wrapper of the hand-written CUDA ring verify-attention kernel
(``csrc/verify_attention.cu``), which replaces the TPU kernel
``verify_attention_call`` of the reference's ``kernels/decode_attention.py``.

``verify_attention`` takes CUDA tensors to the kernel and CPU tensors to the
plain version ``ref.verify_attention_ref``; any other device raises.  For
CUDA tensors it checks device, dtype, shape, contiguity and alignment
(``decode_attention.check_ring``, in one pass), raises on anything the
kernel does not take, allocates the output (and the f32 scratch of the
split partials, when a row can span several splits) with ``torch.empty``,
launches on the current stream without synchronising, and adds one to
``verify_attention.launches``.  Row t of the output is the ring decode
kernel (``decode_attention``) at ``pos + t`` and the same tile, bit for
bit; the kernel computes ``ref.verify_attention_ref(..., block=(bk,),
split=SPLIT_TILES)``.  The tile ``block=(bk,)`` comes from the caller;
``None`` asks the autotuner, whose verify pick is the decode pick
(``decode_attention.ring_tile``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (check_ring, launch_on,
                                                  ring_constants, ring_tile)
from repro_torch.kernels.ref import verify_attention_ref

__all__ = ["verify_attention", "SOURCE"]

SOURCE = "src/repro_torch/kernels/csrc/verify_attention.cu"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    """The bf16 and int8 launchers, bound once."""
    lib = _build.load("verify_attention")
    # pointers (.., out, part), then B, cap, nkv, group, kq, hd, bk, window,
    # splits, 1/sqrt(hd), stream
    dims = [_I] * 9 + [_F, _P]
    lib.repro_verify_attention_bf16.argtypes = [_P] * 7 + dims
    lib.repro_verify_attention_int8.argtypes = [_P] * 9 + dims
    lib.repro_verify_attention_bf16.restype = _I
    lib.repro_verify_attention_int8.restype = _I
    return lib.repro_verify_attention_bf16, lib.repro_verify_attention_int8


def verify_attention(
    q: torch.Tensor,        # (B, kq, n_kv, group, hd) bf16 — post-RoPE
    k: torch.Tensor,        # (B, cap, n_kv, hd) int8 codes or bf16
    v: torch.Tensor,        # (B, cap, n_kv, hd)
    k_pos: torch.Tensor,    # (B, cap) int32
    pos: torch.Tensor,      # (B,) int32 — the first row's position
    k_scale: Optional[torch.Tensor] = None,   # (B, cap, n_kv) f32 when int8
    v_scale: Optional[torch.Tensor] = None,
    *,
    window: int = 0,
    block: Optional[tuple] = None,
) -> torch.Tensor:
    """Verify attention over the ring cache → (B, kq, n_kv, group, hd) f32
    at tile ``block=(bk,)``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if not q.is_cuda:
        if q.device.type == "cpu":
            if block is not None:
                block = (ring_tile("verify_attention", q, k, block),)
            return verify_attention_ref(q, k, v, k_pos, pos, k_scale,
                                        v_scale, window=window, block=block)
        raise ValueError(f"verify_attention runs on cuda (or cpu), not "
                         f"{q.device}")
    if q.dim() != 5:
        raise ValueError(f"q must be (B, kq, n_kv, group, hd); got "
                         f"{tuple(q.shape)}")
    b, kq, nkv, group, hd = q.shape
    if not 1 <= kq <= 65535:
        raise ValueError(f"kq {kq} not in [1, 65535]")
    window = int(window)
    check_ring(q, k, v, k_pos, pos, k_scale, v_scale, window)
    cap = k.shape[1]
    bk = ring_tile("verify_attention", q, k, block)
    splits, inv = ring_constants(cap, hd, bk)
    bf16, int8 = _lib()
    out = torch.empty((b, kq, nkv, group, hd), dtype=torch.float32,
                      device=q.device)
    scratch = (torch.empty((b, kq, nkv, group, splits, hd + 2),
                           dtype=torch.float32, device=q.device)
               if splits > 1 else None)
    part = None if scratch is None else scratch.data_ptr()
    dims = (b, cap, nkv, group, kq, hd, bk, window, splits, inv)
    if k_scale is not None:
        rc = launch_on(q.device, int8, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                       k_pos.data_ptr(), pos.data_ptr(), out.data_ptr(), part,
                       *dims)
    else:
        rc = launch_on(q.device, bf16, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), k_pos.data_ptr(), pos.data_ptr(),
                       out.data_ptr(), part, *dims)
    if rc != 0:
        raise RuntimeError(f"verify_attention kernel launch failed: CUDA "
                           f"error {rc} for shapes q={tuple(q.shape)} "
                           f"k={tuple(k.shape)} {k.dtype}")
    verify_attention.launches += 1
    return out


verify_attention.launches = 0
