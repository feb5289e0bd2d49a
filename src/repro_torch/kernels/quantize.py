"""Wrapper of the hand-written CUDA quantiser (``csrc/quantize.cu``), which
replaces the TPU kernel ``quantize_kernel_call`` of the reference's
``kernels/quantize.py``.

``quantize`` takes CUDA tensors to the kernel and CPU tensors to the plain
version ``ref.quantize_codes_ref``; any other device raises.  For CUDA
tensors it checks device, dtype, shape and contiguity, raises on anything
the kernel does not take, allocates the output with ``torch.empty``,
launches on the current stream without synchronising, and adds one to
``quantize.launches``.  A counter given as a tensor is read on the host.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import rounding
from repro_torch.kernels import _build
from repro_torch.kernels.ref import quantize_codes_ref

__all__ = ["quantize", "SCHEMES", "FMTS", "SOURCE", "u32"]

SOURCE = "src/repro_torch/kernels/csrc/quantize.cu"
# csrc/dither_quant.cuh: Scheme and Fmt
SCHEMES = {"deterministic": 0, "stochastic": 1, "dither": 2}
FMTS = {"spread": 0, "unary": 1}

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("quantize")
    # x, out, total, scale, zero, levels, scheme, fmt, seed, n_pulses, mult,
    # counter, stream
    lib.repro_quantize.argtypes = [_P, _P, ctypes.c_longlong, _F, _F, _F, _I,
                                   _I, _U, _U, _U, _U, _P]
    lib.repro_quantize.restype = _I
    return lib


def u32(v) -> int:
    """A counter or seed as the kernels take it: uint32, two's complement
    for a negative int (a tensor is read on the host)."""
    if isinstance(v, torch.Tensor):
        v = v.item()
    return int(v) & 0xFFFFFFFF


def check_scheme(scheme: str, fmt: str) -> None:
    if scheme not in SCHEMES:
        raise ValueError(f"unknown rounding scheme {scheme!r}; expected one "
                         f"of {tuple(SCHEMES)}")
    if fmt not in FMTS:
        raise ValueError(f"unknown pulse format {fmt!r}; expected one of "
                         f"{tuple(FMTS)}")


def quantize(x: torch.Tensor, *, scale: float, zero: float, bits: int,
             scheme: str, counter, seed: int, n_pulses: int,
             fmt: str = "spread") -> torch.Tensor:
    """k-bit codes of a 2-D f32 tensor → int32 codes of its shape: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return quantize_codes_ref(x, scale=scale, zero=zero, bits=bits,
                                  scheme=scheme, counter=counter, seed=seed,
                                  n_pulses=n_pulses, fmt=fmt)
    if x.device.type != "cuda":
        raise ValueError(f"quantize runs on cuda (or cpu), not {x.device}")
    check_scheme(scheme, fmt)
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D float32 tensor; got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not 1 <= bits <= 16:
        raise ValueError(f"bits {bits} not in [1, 16]")
    if n_pulses < 1:
        raise ValueError(f"n_pulses {n_pulses} < 1")
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().repro_quantize(
            x.data_ptr(), out.data_ptr(), x.numel(), scale, zero,
            float((1 << bits) - 1), SCHEMES[scheme], FMTS[fmt], u32(seed),
            int(n_pulses), rounding._coprime_multiplier(int(n_pulses)),
            u32(counter), stream)
    if rc != 0:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {rc} "
                           f"for x {tuple(x.shape)}")
    quantize.launches += 1
    return out


quantize.launches = 0
