"""Wrapper of the hand-written CUDA flash-decode kernel
(``csrc/decode_attention.cu``), which replaces the TPU kernel
``decode_attention_call`` of the reference's
``kernels/decode_attention.py``.

``decode_attention`` takes CUDA tensors to the kernel and CPU tensors to
the plain version ``ref.decode_attention_ref``; any other device raises.
For CUDA tensors it checks device, dtype, shape, contiguity and alignment,
raises on anything the kernel does not take, allocates the output with
``torch.empty``, launches on the current stream without synchronising, and
adds one to ``decode_attention.launches`` — a plain integer that shows a
run went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref, shrink_block

__all__ = ["decode_attention", "KERNEL_BLOCK", "SOURCE"]

KERNEL_BLOCK = 64     # cache slots per tile (csrc: kMaxBk), shrunk to divide cap
SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
_MAX_GROUP = 16       # csrc: kMaxGroup, one warp per query row

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    # pointers, then B, cap, nkv, group, hd, bk, window, 1/sqrt(hd), stream
    dims = [_I] * 7 + [_F, _P]
    lib.repro_decode_attention_bf16.argtypes = [_P] * 6 + dims
    lib.repro_decode_attention_int8.argtypes = [_P] * 8 + dims
    lib.repro_decode_attention_bf16.restype = _I
    lib.repro_decode_attention_int8.restype = _I
    return lib


def _check(q, k, v, k_pos, pos, k_scale, v_scale, window):
    if k.dim() != 4 or q.dim() != 4:
        raise ValueError(f"q must be (B, n_kv, group, hd) and k, v "
                         f"(B, cap, n_kv, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b, cap, nkv, hd = k.shape
    group = q.shape[2]
    quantized = k.dtype == torch.int8
    want = {
        "q": (q, (b, nkv, group, hd), torch.bfloat16),
        "k": (k, (b, cap, nkv, hd), torch.int8 if quantized else torch.bfloat16),
        "v": (v, (b, cap, nkv, hd), k.dtype),
        "k_pos": (k_pos, (b, cap), torch.int32),
        "pos": (pos, (b,), torch.int32),
    }
    if quantized:
        if k_scale is None or v_scale is None:
            raise ValueError("an int8 cache needs k_scale and v_scale")
        want["k_scale"] = (k_scale, (b, cap, nkv), torch.float32)
        want["v_scale"] = (v_scale, (b, cap, nkv), torch.float32)
    elif k_scale is not None or v_scale is not None:
        raise ValueError("scales are for the int8 cache only")
    if k.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"cache dtype {k.dtype} not int8 or bf16")
    for name, (t, shape, dtype) in want.items():
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hd not in (64, 128):
        raise ValueError(f"head dim {hd} not in (64, 128)")
    if not 1 <= group <= _MAX_GROUP:
        raise ValueError(f"GQA group {group} not in [1, {_MAX_GROUP}]")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must be 16-byte aligned")
    if int(window) < 0:
        raise ValueError(f"window {window} < 0")


def decode_attention(
    q: torch.Tensor,        # (B, n_kv, group, hd) bf16 — post-RoPE queries
    k: torch.Tensor,        # (B, cap, n_kv, hd) int8 codes or bf16
    v: torch.Tensor,        # (B, cap, n_kv, hd)
    k_pos: torch.Tensor,    # (B, cap) int32
    pos: torch.Tensor,      # (B,) int32
    k_scale: Optional[torch.Tensor] = None,   # (B, cap, n_kv) f32 when int8
    v_scale: Optional[torch.Tensor] = None,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Flash-decode attention over the ring cache → (B, n_kv, group, hd) f32:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, k_pos, pos, k_scale, v_scale,
                                    window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda (or cpu), not "
                         f"{q.device}")
    _check(q, k, v, k_pos, pos, k_scale, v_scale, window)
    b, cap, nkv, hd = k.shape
    group = q.shape[2]
    lib = _lib()
    out = torch.empty((b, nkv, group, hd), dtype=torch.float32,
                      device=q.device)
    dims = (b, cap, nkv, group, hd, shrink_block(KERNEL_BLOCK, cap),
            int(window), float(1.0 / math.sqrt(hd)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if k.dtype == torch.int8:
            rc = lib.repro_decode_attention_int8(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), k_pos.data_ptr(), pos.data_ptr(),
                out.data_ptr(), *dims, stream)
        else:
            rc = lib.repro_decode_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(),
                pos.data_ptr(), out.data_ptr(), *dims, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc} for shapes q={tuple(q.shape)} "
                           f"k={tuple(k.shape)} {k.dtype}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
