"""Wrapper of the hand-written CUDA quantiser (``csrc/quantize.cu``), which
replaces the TPU kernel ``quantize_kernel_call`` of the reference's
``kernels/quantize.py``.

``quantize`` takes CUDA tensors to the kernel and CPU tensors to the plain
version ``ref.quantize_codes_ref``; any other device raises.  For CUDA
tensors it checks device, dtype, shape and contiguity, raises on anything
the kernel does not take, allocates the output with ``torch.empty``,
launches on the current stream without synchronising, and adds one to
``quantize.launches``.  A counter given as a tensor is read on the host.
The launch takes no parameter at run time (its grid follows the element
count and the card's SMs), so the autotuner has one candidate for it,
``()`` (``kernels/autotune.py``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import rounding
from repro_torch.kernels import _build
from repro_torch.kernels.ref import quantize_codes_ref

__all__ = ["quantize", "SCHEMES", "FMTS", "SOURCE", "u32", "QuantParams",
           "quant_params", "fastmod_magic", "fastmod",
           "fastmod_mismatches"]

SOURCE = "src/repro_torch/kernels/csrc/quantize.cu"
# csrc/dither_quant.cuh: Scheme and Fmt
SCHEMES = {"deterministic": 0, "stochastic": 1, "dither": 2}
FMTS = {"spread": 0, "unary": 1}

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("quantize")
    # x, out, total, params, stream
    params = ctypes.POINTER(QuantParams)
    lib.repro_quantize.argtypes = [_P, _P, ctypes.c_longlong, params, _P]
    lib.repro_quantize.restype = _I
    # params, lo, count, mismatches, stream
    lib.repro_fastmod_check.argtypes = [params, ctypes.c_ulonglong,
                                        ctypes.c_ulonglong, _P, _P]
    lib.repro_fastmod_check.restype = _I
    return lib


class QuantParams(ctypes.Structure):
    """One operand's quantiser as the kernels take it (``Params`` in
    ``csrc/dither_quant.cuh``, field for field): everything of a code that
    does not depend on the element, computed here once per call."""

    _fields_ = [("scale", _F), ("zero", _F), ("levels", _F), ("n_f", _F),
                ("scheme", _I), ("fmt", _I), ("h0", _U), ("key", _U),
                ("c2", _U), ("counter", _U), ("n_pulses", _U), ("mult", _U),
                ("magic", _U), ("sh1", _U), ("sh2", _U)]


def fastmod_magic(d: int):
    """``(magic, sh1, sh2)`` of the kernels' exact ``x % d`` for every
    uint32 ``x`` and ``1 <= d < 2**32`` (Granlund and Montgomery 1994,
    fig. 4.1, the round-up method): ``l = ceil(log2 d)``, ``magic =
    floor(2**32 (2**l - d) / d) + 1`` (below 2**32), ``sh1 = min(l, 1)``,
    ``sh2 = max(l - 1, 0)``."""
    if not 1 <= d < 1 << 32:
        raise ValueError(f"divisor {d} not in [1, 2**32)")
    l = (d - 1).bit_length()
    return ((1 << 32) * ((1 << l) - d)) // d + 1, min(l, 1), max(l - 1, 0)


def fastmod(x: int, d: int, magic: int, sh1: int, sh2: int) -> int:
    """``x % d`` as ``dither_quant.cuh:mod_n`` computes it, in uint32."""
    t = (x * magic) >> 32
    q = (t + ((x - t) >> sh1)) >> sh2
    return (x - q * d) & rounding._MASK


def quant_params(*, scale: float, zero: float, bits: int, scheme: str,
                 fmt: str, seed, counter, n_pulses: int) -> QuantParams:
    """The kernels' ``Params`` of one operand: the hash's first round
    ``mix(seed ^ golden)`` (the dither's on ``seed ^ 0xD1CE``), the slot
    phase's key, ``counter * M2``, ``f32(N)``, the LCG multiplier and the
    modulo's magic, from the port's mirror of the reference's hash."""
    counter = u32(counter)
    return QuantParams(*_static_params(scale, zero, bits, scheme, fmt,
                                       u32(seed), int(n_pulses)),
                       (counter * rounding._M2) & rounding._MASK, counter,
                       *_pulse_params(int(n_pulses)))


@functools.lru_cache(maxsize=4096)
def _static_params(scale, zero, bits, scheme, fmt, seed, n):
    tail = 0xD1CE if scheme == "dither" else 0
    return (scale, zero, float((1 << bits) - 1), float(np.float32(n)),
            SCHEMES[scheme], FMTS[fmt],
            rounding._mix(seed ^ tail ^ rounding._GOLDEN),
            seed ^ rounding._GOLDEN)


@functools.lru_cache(maxsize=4096)
def _pulse_params(n: int):
    """(N, LCG multiplier, magic, sh1, sh2) of N pulses."""
    return (n, rounding._coprime_multiplier(n), *fastmod_magic(n))


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
    params = quant_params(scale=scale, zero=zero, bits=bits, scheme=scheme,
                          fmt=fmt, seed=seed, counter=counter,
                          n_pulses=n_pulses)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().repro_quantize(x.data_ptr(), out.data_ptr(), x.numel(),
                                   ctypes.byref(params), stream)
    if rc != 0:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {rc} "
                           f"for x {tuple(x.shape)}")
    quantize.launches += 1
    return out


quantize.launches = 0


def fastmod_mismatches(d: int, lo: int = 0, count: int = 1 << 32,
                       device="cuda") -> int:
    """How many uint32 numerators ``x`` in ``[lo, lo + count)`` the
    kernels' modulo (``dither_quant.cuh:mod_n`` with ``fastmod_magic(d)``)
    gets wrong against ``x % d``, counted on the card."""
    params = quant_params(scale=1.0, zero=0.0, bits=8, scheme="dither",
                          fmt="spread", seed=0, counter=0, n_pulses=d)
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(bad.device):
        rc = _lib().repro_fastmod_check(
            ctypes.byref(params), lo, count, bad.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fastmod check launch failed: CUDA error {rc}")
    return int(bad.item())
