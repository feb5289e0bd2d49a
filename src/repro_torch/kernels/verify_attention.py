"""Wrapper of the hand-written CUDA ring verify-attention kernel
(``csrc/verify_attention.cu``), which replaces the TPU kernel
``verify_attention_call`` of the reference's ``kernels/decode_attention.py``.

``verify_attention`` takes CUDA tensors to the kernel and CPU tensors to the
plain version ``ref.verify_attention_ref``; any other device raises.  For
CUDA tensors it checks device, dtype, shape, contiguity and alignment,
raises on anything the kernel does not take, allocates the output with
``torch.empty``, launches on the current stream without synchronising, and
adds one to ``verify_attention.launches``.  Row t of the output is the ring
decode kernel (``decode_attention``) at ``pos + t``, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import KERNEL_BLOCK, check_ring
from repro_torch.kernels.ref import shrink_block, verify_attention_ref

__all__ = ["verify_attention", "SOURCE"]

SOURCE = "src/repro_torch/kernels/csrc/verify_attention.cu"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("verify_attention")
    # pointers, then B, cap, nkv, group, kq, hd, bk, window, 1/sqrt(hd), stream
    dims = [_I] * 8 + [_F, _P]
    lib.repro_verify_attention_bf16.argtypes = [_P] * 6 + dims
    lib.repro_verify_attention_int8.argtypes = [_P] * 8 + dims
    lib.repro_verify_attention_bf16.restype = _I
    lib.repro_verify_attention_int8.restype = _I
    return lib


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
) -> torch.Tensor:
    """Verify attention over the ring cache → (B, kq, n_kv, group, hd) f32:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return verify_attention_ref(q, k, v, k_pos, pos, k_scale, v_scale,
                                    window=window)
    if q.device.type != "cuda":
        raise ValueError(f"verify_attention runs on cuda (or cpu), not "
                         f"{q.device}")
    if q.dim() != 5:
        raise ValueError(f"q must be (B, kq, n_kv, group, hd); got "
                         f"{tuple(q.shape)}")
    b, kq, nkv, group, hd = q.shape
    if not 1 <= kq <= 65535:
        raise ValueError(f"kq {kq} not in [1, 65535]")
    check_ring(q, k, v, k_pos, pos, k_scale, v_scale, window)
    cap = k.shape[1]
    lib = _lib()
    out = torch.empty((b, kq, nkv, group, hd), dtype=torch.float32,
                      device=q.device)
    dims = (b, cap, nkv, group, kq, hd, shrink_block(KERNEL_BLOCK, cap),
            int(window), float(1.0 / math.sqrt(hd)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if k.dtype == torch.int8:
            rc = lib.repro_verify_attention_int8(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), k_pos.data_ptr(), pos.data_ptr(),
                out.data_ptr(), *dims, stream)
        else:
            rc = lib.repro_verify_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(),
                pos.data_ptr(), out.data_ptr(), *dims, stream)
    if rc != 0:
        raise RuntimeError(f"verify_attention kernel launch failed: CUDA "
                           f"error {rc} for shapes q={tuple(q.shape)} "
                           f"k={tuple(k.shape)} {k.dtype}")
    verify_attention.launches += 1
    return out


verify_attention.launches = 0
