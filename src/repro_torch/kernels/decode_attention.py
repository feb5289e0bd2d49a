"""Wrapper of the hand-written CUDA flash-decode kernel
(``csrc/decode_attention.cu``), which replaces the TPU kernel
``decode_attention_call`` of the reference's
``kernels/decode_attention.py``.

``decode_attention`` takes CUDA tensors to the kernel and CPU tensors to
the plain version ``ref.decode_attention_ref``; any other device raises.
For CUDA tensors it checks device, dtype, shape, contiguity and alignment,
raises on anything the kernel does not take, allocates the output (and,
when a slot's tiles can span several splits, the f32 scratch of their
partials) with ``torch.empty``, launches on the current stream without
synchronising, and adds one to ``decode_attention.launches`` — a plain
integer that shows a run went through the kernel — and to
``decode_attention.by_heads[(n_kv, group, hd)]``, the same launches by
the head shape they ran at (a sharded step's local heads).  The kernel
computes
``ref.decode_attention_ref(..., block=(bk,), split=SPLIT_TILES)``.

The tile ``block=(bk,)`` comes from the caller (the engine holds one for
its life); ``None`` asks ``autotune.resolve``, the sweep's winner or the
model pick (the largest tile of at most ``KERNEL_BLOCK`` slots dividing
the cap).  A tile that is not a candidate raises ``ValueError`` before the
launch.  On CPU tensors the plain version runs at the given tile, or as
one whole-cap block.

The launch path is kept short, since a decode tick makes one call per
layer: the checks run in one pass over the inputs, the C functions and the
per-shape constants (split count, ``1/sqrt(hd)``) are bound once, and the
device is switched only when ``q`` is not on the current one.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, autotune
from repro_torch.kernels.autotune import KERNEL_BLOCK, SPLIT_TILES
from repro_torch.kernels.ref import decode_attention_ref

__all__ = ["decode_attention", "check_ring", "ring_constants", "ring_tile",
           "launch_on", "HEAD_DIMS", "KERNEL_BLOCK", "SPLIT_TILES", "SOURCE"]

SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
_MAX_GROUP = 16       # csrc: kMaxGroup
HEAD_DIMS = (64, 128, 256)   # csrc: launch (256: recurrentgemma, ring only)
_CACHE_DTYPES = (torch.int8, torch.bfloat16)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    """The bf16 and int8 launchers, bound once."""
    lib = _build.load("decode_attention")
    # pointers (.., out, part), then B, cap, nkv, group, hd, bk, window,
    # splits, 1/sqrt(hd), stream
    dims = [_I] * 8 + [_F, _P]
    lib.repro_decode_attention_bf16.argtypes = [_P] * 7 + dims
    lib.repro_decode_attention_int8.argtypes = [_P] * 9 + dims
    lib.repro_decode_attention_bf16.restype = _I
    lib.repro_decode_attention_int8.restype = _I
    return lib.repro_decode_attention_bf16, lib.repro_decode_attention_int8


@functools.lru_cache(maxsize=64)
def ring_constants(cap: int, hd: int, bk: int):
    """(splits, 1/sqrt(hd)) of a ring of ``cap`` slots at tile ``bk``: the
    most splits a row can have, and the plain version's f32-rounded
    scale."""
    return -(-(cap // bk) // SPLIT_TILES), float(1.0 / math.sqrt(hd))


def ring_tile(kind: str, q, k, block) -> int:
    """The tile of a ring kernel's launch: ``block`` checked against
    ``autotune``'s candidates at the call's shape (``ValueError``
    otherwise), or with ``block`` None the autotuner's pick.  ``kind`` is
    ``decode_attention`` or ``verify_attention`` (which resolves to the
    decode pick: row t must equal decode at pos + t)."""
    b, cap, nkv, hd = k.shape
    shape = (b, cap, nkv) + tuple(q.shape[1:-3]) + (q.shape[-2], hd)
    if block is not None:
        return autotune.check_block(kind, shape, k.dtype, block)[0]
    bits = 8 if k.dtype == torch.int8 else 16
    return autotune.resolve(kind, shape, k.dtype, bits, "flash", "cuda")[0]


def launch_on(device: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` with ``device`` current (the C launchers launch
    on the calling thread's current device) and the raw handle of its
    current stream (``torch.cuda.current_stream(device).cuda_stream``
    without building a ``Stream`` object: 0.2 µs against 3.5 µs a call on
    the card's host, PERF.md)."""
    index = device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


def _explain_ring(q, k, v, k_pos, pos, k_scale, v_scale):
    """Raise the ValueError that names the first input ``check_ring``'s
    one pass refused."""
    b, cap, nkv, hd = k.shape
    want = [("q", q, (b,) + tuple(q.shape[1:-3]) + (nkv, q.shape[-2], hd),
             torch.bfloat16),
            ("k", k, (b, cap, nkv, hd), k.dtype),
            ("v", v, (b, cap, nkv, hd), k.dtype),
            ("k_pos", k_pos, (b, cap), torch.int32),
            ("pos", pos, (b,), torch.int32)]
    if k_scale is not None:
        want += [("k_scale", k_scale, (b, cap, nkv), torch.float32),
                 ("v_scale", v_scale, (b, cap, nkv), torch.float32)]
    for name, t, shape, dtype in want:
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    raise ValueError("inputs the ring kernels do not take")


def check_ring(q, k, v, k_pos, pos, k_scale, v_scale, window,
               head_dims=(64, 128)):
    """Raise ValueError on any input the ring kernels do not take: q is
    (B, n_kv, group, hd) for decode or (B, kq, n_kv, group, hd) for
    verify, k and v (B, cap, n_kv, hd) bf16 or int8 (then with f32 scales
    (B, cap, n_kv)), k_pos (B, cap) and pos (B,) int32, all on q's device
    and contiguous; hd in ``head_dims`` (the decode kernel also takes
    256), group ≤ 16, k and v 16-byte aligned, window ≥ 0."""
    if k.dim() != 4 or q.dim() not in (4, 5):
        raise ValueError(f"q must be (B, n_kv, group, hd) and k, v "
                         f"(B, cap, n_kv, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    kshape = k.shape
    b, cap, nkv, hd = kshape
    group = q.shape[-2]
    if k.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError("an int8 cache needs k_scale and v_scale")
    elif k_scale is not None or v_scale is not None:
        raise ValueError("scales are for the int8 cache only")
    if k.dtype not in _CACHE_DTYPES:
        raise ValueError(f"cache dtype {k.dtype} not int8 or bf16")
    dev = q.device
    qs = q.shape
    ok = (qs[0] == b and qs[-3] == nkv and qs[-1] == hd
          and q.dtype == torch.bfloat16 and q.is_contiguous()
          and v.shape == kshape and v.dtype == k.dtype
          and k_pos.shape == (b, cap) and k_pos.dtype == torch.int32
          and pos.shape == (b,) and pos.dtype == torch.int32
          and k.device == dev and v.device == dev
          and k_pos.device == dev and pos.device == dev
          and k.is_contiguous() and v.is_contiguous()
          and k_pos.is_contiguous() and pos.is_contiguous())
    if ok and k_scale is not None:
        sshape = kshape[:3]
        ok = (k_scale.shape == sshape and v_scale.shape == sshape
              and k_scale.dtype == torch.float32
              and v_scale.dtype == torch.float32
              and k_scale.device == dev and v_scale.device == dev
              and k_scale.is_contiguous() and v_scale.is_contiguous())
    if not ok:
        _explain_ring(q, k, v, k_pos, pos, k_scale, v_scale)
    if hd not in head_dims:
        raise ValueError(f"head dim {hd} not in {head_dims}")
    if not 1 <= group <= _MAX_GROUP:
        raise ValueError(f"GQA group {group} not in [1, {_MAX_GROUP}]")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must be 16-byte aligned")
    if window < 0:
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
    block: Optional[tuple] = None,
) -> torch.Tensor:
    """Flash-decode attention over the ring cache → (B, n_kv, group, hd) f32
    at tile ``block=(bk,)``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if not q.is_cuda:
        if q.device.type == "cpu":
            if block is not None:
                block = (ring_tile("decode_attention", q, k, block),)
            return decode_attention_ref(q, k, v, k_pos, pos, k_scale,
                                        v_scale, window=window, block=block)
        raise ValueError(f"decode_attention runs on cuda (or cpu), not "
                         f"{q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, n_kv, group, hd); got "
                         f"{tuple(q.shape)}")
    window = int(window)
    check_ring(q, k, v, k_pos, pos, k_scale, v_scale, window, HEAD_DIMS)
    b, cap, nkv, hd = k.shape
    group = q.shape[2]
    bk = ring_tile("decode_attention", q, k, block)
    splits, inv = ring_constants(cap, hd, bk)
    bf16, int8 = _lib()
    out = torch.empty((b, nkv, group, hd), dtype=torch.float32,
                      device=q.device)
    scratch = (torch.empty((b, nkv, group, splits, hd + 2),
                           dtype=torch.float32, device=q.device)
               if splits > 1 else None)
    part = None if scratch is None else scratch.data_ptr()
    dims = (b, cap, nkv, group, hd, bk, window, splits, inv)
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
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc} for shapes q={tuple(q.shape)} "
                           f"k={tuple(k.shape)} {k.dtype}")
    decode_attention.launches += 1
    heads = (nkv, group, hd)
    decode_attention.by_heads[heads] = \
        decode_attention.by_heads.get(heads, 0) + 1
    return out


decode_attention.launches = 0
decode_attention.by_heads = {}
