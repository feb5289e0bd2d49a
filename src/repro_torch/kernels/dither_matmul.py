"""Wrapper of the hand-written CUDA quantise-and-multiply kernel
(``csrc/dither_matmul.cu``), which replaces the TPU kernel
``dither_matmul_kernel_call`` of the reference's
``kernels/dither_matmul.py``.

``dither_matmul`` takes CUDA tensors to the kernel and CPU tensors to the
plain version ``ref.dither_matmul_ref``; any other device raises.  For CUDA
tensors it checks device, dtype, shape and contiguity, raises on anything
the kernel does not take (the limits are in the messages), allocates the
output and the kernel's scratch (u8 code buffers padded to its tiles, the
row and column code sums) with ``torch.empty``, launches on the current
stream without synchronising, and adds one to ``dither_matmul.launches``
per call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import rounding
from repro_torch.kernels import _build
from repro_torch.kernels.quantize import FMTS, SCHEMES, check_scheme, u32
from repro_torch.kernels.ref import dequant_constants, dither_matmul_ref

__all__ = ["dither_matmul", "SOURCE", "MAX_BITS"]

SOURCE = "src/repro_torch/kernels/csrc/dither_matmul.cu"
MAX_BITS = 8                 # codes are u8 in the tensor-core product
_TILE_MN, _TILE_K = 128, 64  # csrc: kBM = kBN, kBK
_GRID_MAX = 65535            # CUDA's limit on gridDim.y

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("dither_matmul")
    lib.repro_dither_matmul.argtypes = (
        [_P] * 7                      # a, b, out, codes_a, codes_bt, sums
        + [_I] * 6                    # M, K, N, Mp, Np, Kp
        + [_F] * 5                    # sa, za, sb, zb, levels
        + [_I] * 2                    # scheme, fmt
        + [_U] * 7                    # seeds, pulses, multipliers, counter
        + [_F] * 4 + [_I, _P])        # epilogue constants, cross, stream
    lib.repro_dither_matmul.restype = _I
    return lib


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def dither_matmul(a: torch.Tensor, b: torch.Tensor, *, bits: int,
                  scheme: str = "dither", a_range=(0.0, 1.0),
                  b_range=(0.0, 1.0), counter=0, seed: int = 0,
                  fmt: str = "spread") -> torch.Tensor:
    """C = dequant(Q(A) · Q(B)) → (M, N) f32 (§VIII 'separate'): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if a.device.type == "cpu":
        return dither_matmul_ref(a, b, bits=bits, scheme=scheme,
                                 a_range=a_range, b_range=b_range,
                                 counter=counter, seed=seed, fmt=fmt)
    if a.device.type != "cuda":
        raise ValueError(f"dither_matmul runs on cuda (or cpu), not "
                         f"{a.device}")
    check_scheme(scheme, fmt)
    for name, t in (("a", a), ("b", b)):
        if t.dim() != 2 or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D float32 "
                             f"tensor; got {tuple(t.shape)} {t.dtype}")
        if t.device != a.device:
            raise ValueError(f"{name} on {t.device}, a on {a.device}")
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if min(m, k, n) < 1:
        raise ValueError(f"empty operand: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"bits {bits} not in [1, {MAX_BITS}] (the kernel "
                         "multiplies u8 codes)")
    levels = (1 << bits) - 1
    if k * levels * levels >= 2 ** 31:
        raise ValueError(f"K={k} at {bits} bits can overflow the kernel's "
                         f"int32 accumulator (K·(2^bits−1)² ≥ 2^31)")
    mp, np_, kp = (_round_up(m, _TILE_MN), _round_up(n, _TILE_MN),
                   _round_up(k, _TILE_K))
    if mp // 8 > _GRID_MAX or kp // 32 > _GRID_MAX:
        raise ValueError(f"M={m} or K={k} too large for the kernel's grid")
    sa, sb, r_acc, c_col, c_row, c_k = dequant_constants(bits, a_range,
                                                         b_range, k)
    cross = a_range[0] != 0.0 or b_range[0] != 0.0
    n_a, n_b = max(n, 2), max(m, 2)
    dev = a.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    codes_a = torch.empty((mp, kp), dtype=torch.uint8, device=dev)
    codes_bt = torch.empty((np_, kp), dtype=torch.uint8, device=dev)
    rowsum = torch.empty((m,), dtype=torch.int32, device=dev)
    colsum = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().repro_dither_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), codes_a.data_ptr(),
            codes_bt.data_ptr(), rowsum.data_ptr(), colsum.data_ptr(),
            m, k, n, mp, np_, kp, sa, a_range[0], sb, b_range[0],
            float(levels), SCHEMES[scheme], FMTS[fmt], u32(seed),
            u32(seed + 1), n_a, rounding._coprime_multiplier(n_a), n_b,
            rounding._coprime_multiplier(n_b), u32(counter), r_acc, c_col,
            c_row, c_k, int(cross), stream)
    if rc != 0:
        raise RuntimeError(f"dither_matmul kernel launch failed: CUDA error "
                           f"{rc} for {tuple(a.shape)} @ {tuple(b.shape)}")
    dither_matmul.launches += 1
    return out


dither_matmul.launches = 0
