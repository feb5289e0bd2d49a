"""Wrapper of the hand-written CUDA quantise-and-multiply kernel
(``csrc/dither_matmul.cu``), which replaces the TPU kernel
``dither_matmul_kernel_call`` of the reference's
``kernels/dither_matmul.py``.

Four entries, one kernel source:

* ``dither_matmul(a, b, ...)`` — f32 operands and static ranges → f32, what
  ``dispatch.matmul`` and the reference's kernel compute;
* ``dither_matmul_scaled(x, w, w_absmax, ...)`` — the quantised-matmul
  policy's product whole (``numerics/policy.py:_fused_matmul``): bf16
  operands normalised by their absmax in the kernel, the product over
  (-1, 1), rescaled to bf16.  The weight may be row-major (K, N) or the
  transposed view of a row-major (N, K) tensor (the tied LM head);
  ``weight_absmax`` computes its absmax once per weight;
* ``dither_matmul_sharded(x, w, x_absmax, w_absmax, block=...)`` — the
  policy's product on one block of operands split over a training mesh
  (``ref.MatmulBlock``): the global absmaxes given, hash indices and pulse
  counts the global product's, so a row or column block is the slice of
  the unsharded product bit for bit; with ``partials`` the int32
  accumulator and code sums of a K block, whose exact all-reduce
  ``dither_matmul_epilogue`` turns into the unsharded product.

Each takes CUDA tensors to the kernel and CPU tensors to its plain version
(``ref.dither_matmul_ref``, ``ref.dither_matmul_scaled_ref``); any other
device raises.  For CUDA tensors it checks device, dtype, shape and layout,
raises on anything the kernel does not take (the limits are in the
messages), plans the grid (``plan``: the decode regime at M <= 128, else
prefill) at the launch parameters its caller gives (``block``; ``None``
asks the autotuner, ``kernels/autotune.py``), allocates the output and
the per-call scratch with ``torch.empty``, keeps the decode regime's split scratch (zero between
calls; the kernel leaves it so) per device and stream, launches on the
current stream without synchronising, and adds one to
``dither_matmul.launches`` per call of any entry but the epilogue (the
policy entry also
to ``dither_matmul_scaled.launches``, the sharded entry to
``dither_matmul_sharded.launches`` and to its block kind's count in
``dither_matmul_sharded.by_block``; the epilogue counts in
``dither_matmul_epilogue.launches`` only).
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Optional

import torch

from repro_torch.kernels import _build, autotune
from repro_torch.kernels.autotune import (DECODE_MAX_M, MIN_BLOCKS,
                                          PREFILL_BLOCK, TARGET_BLOCKS)
from repro_torch.kernels.decode_attention import launch_on
from repro_torch.kernels.quantize import QuantParams, check_scheme, quant_params
from repro_torch.kernels.ref import (MatmulBlock, dequant_constants,
                                     dither_matmul_ref,
                                     dither_matmul_scaled_epilogue_ref,
                                     dither_matmul_scaled_ref, policy_absmax)

__all__ = ["dither_matmul", "dither_matmul_scaled", "dither_matmul_sharded",
           "dither_matmul_epilogue", "weight_absmax", "plan", "SOURCE",
           "MAX_BITS", "DECODE_MAX_M", "MIN_BLOCKS", "TARGET_BLOCKS",
           "normalise_mismatches"]

SOURCE = "src/repro_torch/kernels/csrc/dither_matmul.cu"
MAX_BITS = 8                 # codes are u8 in the tensor-core product
_TILE_MN, _TILE_K = PREFILL_BLOCK[1:]   # prefill: kBM = kBN, kBK
_GRID_MAX = 65535            # CUDA's limit on gridDim.y
_KINDS = {"f32": 0, "row": 1, "trans": 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U = ctypes.c_uint
_WHOLE = 0x7FFFFFFF          # csrc kWhole: one row segment


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("dither_matmul")
    params = ctypes.POINTER(QuantParams)
    lib.repro_dither_matmul.argtypes = (
        [_P] * 11                     # a, b, out, scratch, absmaxes
        + [_I] * 3                    # M, K, N
        + [_I] * 5                    # kind, mt, cps, splits, async
        + [_I] * 3                    # Mp, Np, Kp
        + [params] * 2                # A's and B's quantiser
        + [_F] * 4 + [_I, _P])        # epilogue constants, cross, stream
    lib.repro_dither_matmul.restype = _I
    lib.repro_dither_matmul_sharded.argtypes = (
        [_P] * 9                      # x, w, out, scratch, absmaxes
        + [_I] * 7                    # M, K, N, kind, Mp, Np, Kp
        + [_U, _I] + [_U] * 4         # a_base, seg, seg_stride, Kg, b, Ng
        + [_I, params, params]        # partials, quantisers
        + [_F] * 4 + [_I, _P])        # epilogue constants, cross, stream
    lib.repro_dither_matmul_sharded.restype = _I
    lib.repro_dither_matmul_epilogue.argtypes = (
        [_P] * 4 + [_I] * 2 + [_P] * 2 + [_F] * 4 + [_I, _P])
    lib.repro_dither_matmul_epilogue.restype = _I
    lib.repro_div_check.argtypes = [_P, _P]
    lib.repro_div_check.restype = _I
    return lib


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@functools.lru_cache(maxsize=1024)
def plan(m: int, k: int, n: int, block: Optional[tuple] = None) -> dict:
    """The grid of an (m, k) @ (k, n) product at launch parameters
    ``block`` (an ``autotune.matmul_candidates`` entry; ``None``: the
    model pick, ``autotune.model_block``).

    Decode (``m <= DECODE_MAX_M``), ``block = (mt, cps, splits)``: ``mt``
    8-row MMA tiles hold every row; one block of 256 threads per 16-column
    weight strip and split, each split ``cps`` 32-deep K chunks (the last
    may be shorter).  Prefill: 128 x 128 output tiles over operands padded
    to (mp, kp) and (np, kp).
    """
    if block is None:
        block = autotune.model_block("matmul", (m, k, n), "float32")
    if m > DECODE_MAX_M:
        mp, np_ = _round_up(m, _TILE_MN), _round_up(n, _TILE_MN)
        return {"regime": "prefill", "mp": mp, "np": np_,
                "kp": _round_up(k, _TILE_K),
                "blocks": (mp // _TILE_MN) * (np_ // _TILE_MN)}
    mt, cps, splits = block
    strips, chunks = -(-n // 16), -(-k // 32)
    return {"regime": "decode", "mt": mt, "strips": strips, "chunks": chunks,
            "cps": cps, "splits": splits, "blocks": strips * splits}


def _block(m: int, k: int, n: int, dtype, bits: int, scheme: str,
           block: Optional[tuple]) -> tuple:
    """A product's launch parameters: ``block`` checked against the
    autotuner's candidates (``ValueError`` otherwise), or with ``block``
    None the autotuner's pick."""
    if block is not None:
        return autotune.check_block("matmul", (m, k, n), dtype, block)
    return autotune.resolve("matmul", (m, k, n), dtype, bits, scheme, "cuda")


class _Scratch:
    """One device and stream's reusable scratch, grown on demand.  The
    ``zero`` buffers (the decode split's partial sums and arrival counts)
    are zero between calls: allocated so, and left so by the kernel."""

    def __init__(self, device):
        self.device = device
        self.bufs = {}

    def get(self, name: str, numel: int, dtype, zero: bool = False):
        t = self.bufs.get(name)
        if t is None or t.numel() < numel:
            make = torch.zeros if zero else torch.empty
            t = self.bufs[name] = make(max(numel, 1), dtype=dtype,
                                       device=self.device)
        return t


_SCRATCH = {}


def _scratch(device, stream: int) -> _Scratch:
    key = (device.index, stream)
    if key not in _SCRATCH:
        _SCRATCH[key] = _Scratch(device)
    return _SCRATCH[key]


def _check_common(bits: int, scheme: str, fmt: str, k: int) -> None:
    check_scheme(scheme, fmt)
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"bits {bits} not in [1, {MAX_BITS}] (the kernel "
                         "multiplies u8 codes)")
    levels = (1 << bits) - 1
    if k * levels * levels >= 2 ** 31:
        raise ValueError(f"K={k} at {bits} bits can overflow the kernel's "
                         f"int32 accumulator (K·(2^bits−1)² ≥ 2^31)")


_constants = functools.lru_cache(maxsize=1024)(dequant_constants)


def _launch(kind: str, a, b, out, w_absmax, m: int, k: int, n: int, *,
            bits, scheme, a_range, b_range, counter, seed, fmt,
            block) -> None:
    """One call of the C entry: the plan at ``block`` (see ``_block``), the
    scratch and both quantisers (A: ``seed``, N_A = max(N, 2) pulses; B:
    ``seed + 1``, N_B = max(M, 2))."""
    p = plan(m, k, n, _block(m, k, n, a.dtype, bits, scheme, block))
    a_range, b_range = tuple(a_range), tuple(b_range)
    sa, sb, r_acc, c_col, c_row, c_k = _constants(bits, a_range, b_range, k)
    cross = a_range[0] != 0.0 or b_range[0] != 0.0
    q = dict(bits=bits, scheme=scheme, fmt=fmt, counter=counter)
    pa = quant_params(scale=sa, zero=a_range[0], seed=seed,
                      n_pulses=max(n, 2), **q)
    pb = quant_params(scale=sb, zero=b_range[0], seed=seed + 1,
                      n_pulses=max(m, 2), **q)
    dev = a.device
    s = _scratch(dev, torch._C._cuda_getCurrentRawStream(dev.index))
    x_absmax = s.get("x_absmax", 1, torch.float32)
    if p["regime"] == "decode":
        mt, cps, splits = p["mt"], p["cps"], p["splits"]
        mp = np_ = kp = 0
        codes_a = s.get("codes_a", 8 * mt * 32 * p["chunks"], torch.uint8)
        codes_bt = None
        rowsum = s.get("rowsum", m, torch.int32)
        if splits > 1:
            colsum = s.get("colacc", n, torch.int32, zero=True)
            acc = s.get("acc", m * n, torch.int32, zero=True)
            arrivals = s.get("arrivals", p["strips"], torch.int32, zero=True)
        else:
            colsum = acc = arrivals = None
        row_bytes = (k if kind == "trans" else n) * b.element_size()
        aligned = b.data_ptr() % 16 == 0 and row_bytes % 16 == 0
    else:
        mt = cps = splits = aligned = 0
        mp, np_, kp = p["mp"], p["np"], p["kp"]
        if mp // _TILE_MN > _GRID_MAX:
            raise ValueError(f"M={m} too large for the kernel's grid")
        codes_a = torch.empty((mp, kp), dtype=torch.uint8, device=dev)
        codes_bt = torch.empty((np_, kp), dtype=torch.uint8, device=dev)
        rowsum = torch.empty((m,), dtype=torch.int32, device=dev)
        colsum = torch.empty((n,), dtype=torch.int32, device=dev)
        acc = arrivals = None

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = launch_on(
        dev, _lib().repro_dither_matmul, a.data_ptr(), b.data_ptr(),
        out.data_ptr(), ptr(codes_a), ptr(codes_bt), ptr(rowsum),
        ptr(colsum), ptr(acc), ptr(arrivals), x_absmax.data_ptr(),
        ptr(w_absmax), m, k, n, _KINDS[kind], mt, cps, splits, int(aligned),
        mp, np_, kp, ctypes.byref(pa), ctypes.byref(pb), r_acc, c_col, c_row,
        c_k, int(cross))
    if rc != 0:
        raise RuntimeError(f"dither_matmul kernel launch failed: CUDA error "
                           f"{rc} for {tuple(a.shape)} @ {tuple(b.shape)}")
    dither_matmul.launches += 1


def dither_matmul(a: torch.Tensor, b: torch.Tensor, *, bits: int,
                  scheme: str = "dither", a_range=(0.0, 1.0),
                  b_range=(0.0, 1.0), counter=0, seed: int = 0,
                  fmt: str = "spread",
                  block: Optional[tuple] = None) -> torch.Tensor:
    """C = dequant(Q(A) · Q(B)) → (M, N) f32 (§VIII 'separate'): the CUDA
    kernel for CUDA tensors at launch parameters ``block`` (``_block``),
    the plain version for CPU tensors (the same bits at any block)."""
    if a.device.type == "cpu":
        return dither_matmul_ref(a, b, bits=bits, scheme=scheme,
                                 a_range=a_range, b_range=b_range,
                                 counter=counter, seed=seed, fmt=fmt)
    if a.device.type != "cuda":
        raise ValueError(f"dither_matmul runs on cuda (or cpu), not "
                         f"{a.device}")
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
    _check_common(bits, scheme, fmt, k)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _launch("f32", a, b, out, None, m, k, n, bits=bits, scheme=scheme,
            a_range=a_range, b_range=b_range, counter=counter, seed=seed,
            fmt=fmt, block=block)
    return out


dither_matmul.launches = 0


def _weight_layout(w: torch.Tensor) -> str:
    """``"row"`` for a row-major (K, N) weight, ``"trans"`` for the
    transposed view of a row-major (N, K) one; raises on any other."""
    if w.is_contiguous():
        return "row"
    if w.T.is_contiguous():
        return "trans"
    raise ValueError(f"w must be row-major (K, N) or the transposed view of "
                     f"a row-major (N, K) tensor; got strides {w.stride()}")


def dither_matmul_scaled(x: torch.Tensor, w: torch.Tensor,
                         w_absmax: torch.Tensor, *, bits: int,
                         scheme: str = "dither", counter=0, seed: int = 0,
                         fmt: str = "spread",
                         block: Optional[tuple] = None) -> torch.Tensor:
    """The policy's product → (M, N) bf16: x (M, K) and w (K, N) bf16, each
    normalised by its absmax (x's reduced in the kernel, w's given as the
    0-dim bf16 ``w_absmax``, see ``weight_absmax``), quantised over (-1, 1)
    with ``seed`` / ``seed + 1``, multiplied, dequantised and scaled by
    ``bf16(ax · aw)``: the CUDA kernel for CUDA tensors at launch
    parameters ``block`` (``_block``), the plain version
    (``ref.dither_matmul_scaled_ref``) for CPU tensors."""
    if x.device.type == "cpu":
        return dither_matmul_scaled_ref(x, w, w_absmax, bits=bits,
                                        scheme=scheme, counter=counter,
                                        seed=seed, fmt=fmt)
    if x.device.type != "cuda":
        raise ValueError(f"dither_matmul_scaled runs on cuda (or cpu), not "
                         f"{x.device}")
    for name, t in (("x", x), ("w", w), ("w_absmax", w_absmax)):
        if t.dtype != torch.bfloat16 or t.device != x.device:
            raise ValueError(f"{name} must be bfloat16 on {x.device}; got "
                             f"{t.dtype} on {t.device}")
    if x.dim() != 2 or w.dim() != 2 or w_absmax.dim() != 0:
        raise ValueError(f"x and w must be 2-D and w_absmax 0-D; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(w_absmax.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"x must be contiguous; got strides {x.stride()}")
    (m, k), (k2, n) = x.shape, w.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if min(m, k, n) < 1:
        raise ValueError(f"empty operand: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    _check_common(bits, scheme, fmt, k)
    kind = _weight_layout(w)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    _launch(kind, x, w, out, w_absmax, m, k, n, bits=bits, scheme=scheme,
            a_range=(-1.0, 1.0), b_range=(-1.0, 1.0), counter=counter,
            seed=seed, fmt=fmt, block=block)
    dither_matmul_scaled.launches += 1
    return out


dither_matmul_scaled.launches = 0

def _check_bf16(ref, **named):
    for name, t in named.items():
        if t.dtype != torch.bfloat16 or t.device != ref.device:
            raise ValueError(f"{name} must be bfloat16 on {ref.device}; got "
                             f"{t.dtype} on {t.device}")


def dither_matmul_sharded(x: torch.Tensor, w: torch.Tensor,
                          x_absmax: torch.Tensor, w_absmax: torch.Tensor, *,
                          block: MatmulBlock, partials: bool = False,
                          bits: int, scheme: str = "dither", counter=0,
                          seed: int = 0, fmt: str = "spread"):
    """The policy's product on one block of a sharded product → (M, N)
    bf16, or with ``partials`` the int32 ``(acc (M, N), rowsum (M,),
    colsum (N,))`` of a K block: x (M, K) and w (K, N) bf16 (w row-major
    or the transposed view of a row-major (N, K) weight), ``x_absmax`` and
    ``w_absmax`` the global operands' 0-dim bf16 absmaxes, ``block`` the
    global shape and this block's offsets.  The CUDA kernel for CUDA
    tensors, ``ref.dither_matmul_scaled_ref`` for CPU tensors."""
    kw = dict(bits=bits, scheme=scheme, counter=counter, seed=seed, fmt=fmt)
    if x.device.type == "cpu":
        return dither_matmul_scaled_ref(x, w, w_absmax, x_absmax=x_absmax,
                                        block=block, partials=partials, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"dither_matmul_sharded runs on cuda (or cpu), not "
                         f"{x.device}")
    _check_bf16(x, x=x, w=w, x_absmax=x_absmax, w_absmax=w_absmax)
    if x.dim() != 2 or w.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous 2-D and w 2-D; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    (m, k), (k2, n) = x.shape, w.shape
    if k != k2 or min(m, k, n) < 1:
        raise ValueError(f"bad operands: {tuple(x.shape)} @ {tuple(w.shape)}")
    if (block.m0 + m > block.M and not block.seg) or block.k0 + k > block.K \
            or block.n0 + n > block.N:
        raise ValueError(f"block {block} does not hold a {m} x {k} @ {k} x "
                         f"{n} product")
    _check_common(bits, scheme, fmt, block.K)
    kind = _weight_layout(w)
    mp, np_, kp = (_round_up(m, _TILE_MN), _round_up(n, _TILE_MN),
                   _round_up(k, _TILE_K))
    if mp // _TILE_MN > _GRID_MAX:
        raise ValueError(f"M={m} too large for the kernel's grid")
    sa, sb, r_acc, c_col, c_row, c_k = _constants(bits, (-1.0, 1.0),
                                                  (-1.0, 1.0), block.K)
    q = dict(bits=bits, scheme=scheme, fmt=fmt, counter=counter)
    pa = quant_params(scale=sa, zero=-1.0, seed=seed,
                      n_pulses=max(block.N, 2), **q)
    pb = quant_params(scale=sb, zero=-1.0, seed=seed + 1,
                      n_pulses=max(block.M, 2), **q)
    dev = x.device
    out = torch.empty((m, n), dtype=torch.int32 if partials
                      else torch.bfloat16, device=dev)
    rowsum = torch.empty((m,), dtype=torch.int32, device=dev)
    colsum = torch.empty((n,), dtype=torch.int32, device=dev)
    codes_a = torch.empty((mp, kp), dtype=torch.uint8, device=dev)
    codes_bt = torch.empty((np_, kp), dtype=torch.uint8, device=dev)
    ax = x_absmax.to(torch.float32).reshape(1)
    mask = 0xFFFFFFFF
    rc = launch_on(
        dev, _lib().repro_dither_matmul_sharded, x.data_ptr(), w.data_ptr(),
        out.data_ptr(), codes_a.data_ptr(), codes_bt.data_ptr(),
        rowsum.data_ptr(), colsum.data_ptr(), ax.data_ptr(),
        w_absmax.data_ptr(), m, k, n, _KINDS[kind], mp, np_, kp,
        (block.m0 * block.K + block.k0) & mask, block.seg or _WHOLE,
        block.seg_stride & mask, block.K & mask,
        (block.k0 * block.N + block.n0) & mask, block.N & mask,
        int(partials), ctypes.byref(pa), ctypes.byref(pb), r_acc, c_col,
        c_row, c_k, 1)
    if rc != 0:
        raise RuntimeError(f"dither_matmul_sharded kernel launch failed: CUDA "
                           f"error {rc} for {tuple(x.shape)} @ "
                           f"{tuple(w.shape)}")
    dither_matmul.launches += 1
    dither_matmul_sharded.launches += 1
    dither_matmul_sharded.by_block[
        "k_block" if partials else "columns" if n < block.N else "rows"] += 1
    return (out, rowsum, colsum) if partials else out


dither_matmul_sharded.launches = 0
# launches by the kind of block: a K block's partials, a block of the
# weight's columns (on a (2, 2) mesh of rows too), else a block of rows
dither_matmul_sharded.by_block = {"rows": 0, "columns": 0, "k_block": 0}


def dither_matmul_epilogue(acc: torch.Tensor, rowsum: torch.Tensor,
                           colsum: torch.Tensor, x_absmax: torch.Tensor,
                           w_absmax: torch.Tensor, *, bits: int,
                           k: int) -> torch.Tensor:
    """The sharded policy product from all-reduced partials → (M, N) bf16:
    the epilogue at the global ``k`` and the scale ``bf16(ax · aw)``; the
    CUDA kernel for CUDA tensors, ``ref.dither_matmul_scaled_epilogue_ref``
    for CPU tensors."""
    if acc.device.type == "cpu":
        return dither_matmul_scaled_epilogue_ref(acc, rowsum, colsum,
                                                 x_absmax, w_absmax,
                                                 bits=bits, k=k)
    if acc.device.type != "cuda":
        raise ValueError(f"dither_matmul_epilogue runs on cuda (or cpu), not "
                         f"{acc.device}")
    (m, n) = acc.shape
    for name, t, want in (("acc", acc, (m, n)), ("rowsum", rowsum, (m,)),
                          ("colsum", colsum, (n,))):
        if t.dtype != torch.int32 or tuple(t.shape) != want \
                or not t.is_contiguous() or t.device != acc.device:
            raise ValueError(f"{name} must be a contiguous int32 {want} "
                             f"tensor on {acc.device}")
    _check_bf16(acc, x_absmax=x_absmax, w_absmax=w_absmax)
    _, _, r_acc, c_col, c_row, c_k = _constants(bits, (-1.0, 1.0),
                                                (-1.0, 1.0), k)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=acc.device)
    ax = x_absmax.to(torch.float32).reshape(1)
    rc = launch_on(acc.device, _lib().repro_dither_matmul_epilogue,
                   acc.data_ptr(), rowsum.data_ptr(), colsum.data_ptr(),
                   out.data_ptr(), m, n, ax.data_ptr(), w_absmax.data_ptr(),
                   r_acc, c_col, c_row, c_k, 1)
    if rc != 0:
        raise RuntimeError(f"dither_matmul_epilogue launch failed: CUDA "
                           f"error {rc} for ({m}, {n})")
    dither_matmul_epilogue.launches += 1
    return out


dither_matmul_epilogue.launches = 0

_ABSMAX = {}
_ABSMAX_MAX = 4096


def weight_absmax(w: torch.Tensor) -> torch.Tensor:
    """The policy's range of a weight, ``ref.policy_absmax(w)``, computed
    once per weight: it does not depend on the counter.  Cached on the
    tensor's storage address, shape, strides and dtype, and checked against
    the tensor that owns the storage (alive, the same object) and its
    ``_version``, so an in-place update recomputes it and a new tensor at a
    freed address does not inherit it."""
    if w.is_inference():
        return policy_absmax(w)
    base = w if w._base is None else w._base
    key = (w.device, w.data_ptr(), tuple(w.shape), w.stride(), w.dtype)
    hit = _ABSMAX.get(key)
    if hit is not None and hit[0]() is base and hit[1] == w._version:
        return hit[2]
    absmax = policy_absmax(w)
    if len(_ABSMAX) >= _ABSMAX_MAX:
        _ABSMAX.clear()
    _ABSMAX[key] = (weakref.ref(base), w._version, absmax)
    return absmax


def normalise_mismatches(device="cuda"):
    """How many pairs of a bf16 value x and a finite bf16 absmax >=
    bf16(1e-6) the kernel's reciprocal normalisation
    (``dither_quant.cuh:normalise_rcp``) gets wrong against
    ``bf16(x / absmax)``: (among |x| <= absmax, the policy's case; among
    all pairs), counted on the card."""
    bad = torch.zeros(2, dtype=torch.int64, device=device)
    rc = launch_on(bad.device, _lib().repro_div_check, bad.data_ptr())
    if rc != 0:
        raise RuntimeError(f"division check launch failed: CUDA error {rc}")
    return tuple(int(v) for v in bad.tolist())
